"""The comparison that decides ``correct``: what the timed calls returned,
held against the plain reference's answer for the same inputs and
weights, each number beside its limit.

Numbers compared (the largest over the checked requests of a run):

  wave_gap   ||program waveform - reference waveform|| / ||reference||
             over each checked clip (every clip of a checked batch call)
  roll_gap   the same of the piano roll a V2P call produced
  feature_gap  under int8 towers: the same of each frame's features of
             each tower, the largest over the frames; there the
             waveform's reference starts from the program's features, so
             ``wave_gap`` does not cover the towers
  layer_gap  under int8 towers: the same of each kept row of a few int8
             layers (``benchmark/kept.py``) against AQT's int8 product in
             the tower's compute dtype on the same input row

A cell's limits are ``benchmark/limits/<cell>.json``; ``PERF.md`` gives the
readings each was set from.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def rel_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """Relative L2 gap; a program output of another shape, or not finite,
    reads infinite."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if program.shape != reference.shape or not np.isfinite(program).all():
        return float("inf")
    return float(np.linalg.norm(program - reference)
                 / max(np.linalg.norm(reference), 1e-30))


def row_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The largest ``rel_gap`` of a row (last axis) of ``program`` from the
    same row of ``reference``."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if program.shape != reference.shape or not np.isfinite(program).all():
        return float("inf")
    if program.size == 0:
        return 0.0
    return float((np.linalg.norm(program - reference, axis=-1)
                  / np.maximum(np.linalg.norm(reference, axis=-1), 1e-30))
                 .max())


def load_limits(root: Path, cell: str) -> dict:
    with open(Path(root) / "benchmark" / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each reading must lie at or
    under its limit; a limit without a reading fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks
