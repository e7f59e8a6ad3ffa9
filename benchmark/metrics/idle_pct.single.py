"""The device's idle share (%) of the window: one - the device's busy
seconds a call, from the traced calls (the union of their kernels', copies'
and fills' intervals), x the window's calls / the window's seconds. The
window runs without the profiler, so its slower host does not count."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
