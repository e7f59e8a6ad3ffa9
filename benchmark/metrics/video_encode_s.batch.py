"""Median over the window's ``generate_batch`` calls of the pipeline's own
``last_timings["video_encode_s"]`` (s): the towers' spans of every clip,
summed over the call; nothing where no call timed them."""

from benchmark.readers import stage_median


def read(run):
    return stage_median(run, "video_encode_s")
