"""The whole call's share of the chip's peak (%): the model operations of
the calls completed in the window (towers, T5, Video2Roll, every CFG
evaluation, the decoder; ``counts.request_flops``) over the window's
seconds at 989 TFLOP/s. The window runs without the profiler."""

from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run)
