"""Median over the window's ``generate_batch`` calls of the pipeline's
own ``last_timings["sample_s"]`` (s)."""

from benchmark.readers import stage_median


def read(run):
    return stage_median(run, "sample_s")
