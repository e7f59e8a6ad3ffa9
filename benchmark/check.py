"""The comparison that decides ``correct``: what the timed calls returned,
held against the plain reference's answer for the same inputs and
weights, each number beside its limit.

Numbers compared (the largest over the checked requests of a run):

  wave_gap   ||program waveform - reference waveform|| / ||reference||
             over each checked clip (every clip of a checked batch call)
  roll_gap   the same of the piano roll a V2P call produced

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
