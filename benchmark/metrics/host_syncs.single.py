"""Median over the window's ``generate`` calls of the pipeline's own
``last_timings["host_syncs"]`` (a count): the points where a call waits
for the card (each blocking upload, each copy back); nothing where no call
counted them."""

from benchmark.readers import stage_median


def read(run):
    return stage_median(run, "host_syncs")
