"""Multilabel roll evaluation metrics (Audeo eval scripts re-designed).

Counterpart of ``v2ap_tpu/audeo/evaluate.py`` (the port's own copy; numpy
on the host).

The reference computes sklearn multilabel confusion matrices at threshold 0.4
over estimated rolls vs ground truth (Roll2Midi_evaluate.py:18-60,
Video2Roll_evaluate.py), including the ``_tv2a`` variants that score
transcriptions of generated audio against GT rolls. Here the metrics are
vectorised numpy (identical numbers) with a small report type.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RollMetrics:
    precision: float
    recall: float
    f1: float
    accuracy: float
    tp: int
    fp: int
    fn: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def evaluate_rolls(pred: np.ndarray, gt: np.ndarray,
                   pred_threshold: float = 0.4,
                   gt_threshold: float = 0.5) -> RollMetrics:
    """pred/gt: (frames, keys) probabilities/activations."""
    p = pred >= pred_threshold
    g = gt >= gt_threshold
    tp = int(np.sum(p & g))
    fp = int(np.sum(p & ~g))
    fn = int(np.sum(~p & g))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else 0.0
    accuracy = tp / (tp + fp + fn) if tp + fp + fn else 0.0
    return RollMetrics(precision, recall, f1, accuracy, tp, fp, fn)


def evaluate_per_key(pred: np.ndarray, gt: np.ndarray,
                     pred_threshold: float = 0.4) -> np.ndarray:
    """Per-key F1 array (keys,) — the reference's per-class breakdown."""
    p = pred >= pred_threshold
    g = gt >= 0.5
    tp = np.sum(p & g, axis=0).astype(np.float64)
    fp = np.sum(p & ~g, axis=0).astype(np.float64)
    fn = np.sum(~p & g, axis=0).astype(np.float64)
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
