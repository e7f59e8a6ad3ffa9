"""Keyboard crop-box registry (reference: src/audeo/piano_coords.py — a
hardcoded list of per-video keyboard regions for the Audeo YouTube set).

Counterpart of ``v2ap_tpu/audeo/piano_coords.py``, with the port's own copy
of ``piano_coords_data.json``.

The registry is data-driven: the reference's 24 train + 3 test crop boxes
ship as the default registry (``piano_coords_data.json``, ids ``train_00``..
``train_23`` / ``test_00``..``test_02``; reference boxes are
(upper_left_x, upper_left_y, lower_right_x, lower_right_y) and are converted
to this module's (top, bottom, left, right) order on load). Extra boxes load
from JSON or register programmatically; ``crop_keyboard`` applies one to
decoded frames before the 900x100 grayscale preprocessing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

Box = Tuple[int, int, int, int]            # (top, bottom, left, right)

_DATA = os.path.join(os.path.dirname(__file__), "piano_coords_data.json")
_REGISTRY: Dict[str, Box] = {}
_DEFAULTS_LOADED = False


def _registry() -> Dict[str, Box]:
    """The registry, with the reference's boxes loaded into it on first use
    (importing this module reads no file)."""
    global _DEFAULTS_LOADED
    if not _DEFAULTS_LOADED:
        _DEFAULTS_LOADED = True
        with open(_DATA) as f:
            data = json.load(f)
        for split in ("train", "test"):
            for i, (x0, y0, x1, y1) in enumerate(data[split]):
                _REGISTRY.setdefault(f"{split}_{i:02d}", (y0, y1, x0, x1))
    return _REGISTRY


def reference_boxes(split: str = "train") -> list:
    """The reference's raw (x0, y0, x1, y1) boxes for the Audeo videos."""
    with open(_DATA) as f:
        return [tuple(b) for b in json.load(f)[split]]


def register(video_id: str, box: Box) -> None:
    _registry()[video_id] = tuple(int(v) for v in box)


def get(video_id: str) -> Optional[Box]:
    return _registry().get(video_id)


def load_registry(path: str) -> int:
    with open(path) as f:
        data = json.load(f)
    for vid, box in data.items():
        register(vid, box)
    return len(data)


def save_registry(path: str) -> None:
    with open(path, "w") as f:
        json.dump({k: list(v) for k, v in _registry().items()}, f,
                  indent=2)


def crop_keyboard(frames: np.ndarray, box: Box) -> np.ndarray:
    """frames (t, H, W, ...) -> cropped to the keyboard region."""
    top, bottom, left, right = box
    return frames[:, top:bottom, left:right]
