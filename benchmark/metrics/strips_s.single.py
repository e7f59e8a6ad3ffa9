"""Median over the window's V2P ``generate`` calls of the pipeline's own
``last_timings["strips_s"]`` (s): the keyboard strips' decode, blend plan
and upload (its ``strips`` span); nothing where no call timed it."""

from benchmark.readers import stage_median


def read(run):
    return stage_median(run, "strips_s")
