"""Seconds of audio completed per second of window: every clip of every
call completed in the window over the window's whole length."""

from benchmark.stats import rate


def read(run):
    clips = sum(r.clips for r in run.window_records() if r.waves is not None)
    return rate(clips * run.cell.traffic["clip_s"], run.window_s)
