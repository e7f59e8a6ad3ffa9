"""Median over the window's ``generate`` calls of the pipeline's own
``last_timings["roll_s"]`` (s); nothing where no call timed it."""

from benchmark.readers import stage_median


def read(run):
    return stage_median(run, "roll_s")
