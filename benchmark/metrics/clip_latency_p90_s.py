"""90th-percentile latency (s) over every call completed in the window, by
the host clock around the call."""

from benchmark.stats import percentile


def read(run):
    return percentile([r.latency_s for r in run.window_records()], 90.0)
