"""Median over the window's ``generate_batch`` calls of the pipeline's own
``last_timings["upload_s"]`` (s): every frame chunk's contiguous copy and
upload, summed over the chunks and clips of the call; nothing where no
call timed it."""

from benchmark.readers import stage_median


def read(run):
    return stage_median(run, "upload_s")
