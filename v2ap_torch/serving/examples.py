"""Built-in demo examples for the HTTP UI.

Counterpart of ``v2ap_tpu/serving/examples.py``: the reference's clickable
examples (two V2A clips, two cropped piano clips) ship as LFS stubs, so
the server synthesizes a deterministic demo clip (cv2, the same codec path
uploads take) and runs it through the upload pipeline:
``GET /example?mode=v2a|v2p`` behaves like posting the bundled example
would. Without cv2's video writer it raises.

Note on untrained weights: the two examples produce IDENTICAL audio until a
real checkpoint is loaded — conditioning reaches the audio stream only
through the zero-initialised CrossCondition fusions (and near-zero AdaLN
gates), so a constructor-initialised CFM is conditioning-independent by
construction. This is the expected cold-start behavior, not an example
routing bug; with converted weights the modes diverge.

Two content classes:
  * v2a — a smooth translating low-frequency texture (codec-like content,
    the class every serving-default drift bound is measured on);
  * v2p — a keyboard-shaped frame (white/black key bands over the bottom
    strip region) with a moving "pressed key" highlight, so the piano path's
    strip crop + Video2Roll sees key-like structure.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

EXAMPLES = ("v2a", "v2p")


def example_clip_path(mode: str, seconds: float = 6.0) -> str:
    """Synthesize (once) and return the demo clip for ``mode``."""
    assert mode in EXAMPLES, mode
    path = os.path.join(tempfile.gettempdir(),
                        f"v2ap_example_{mode}_{int(seconds * 10)}.mp4")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    if not _write_example(path, mode, seconds):
        raise RuntimeError("cv2 video writer unavailable")
    return path


def _write_example(path: str, mode: str, seconds: float,
                   fps: int = 24, size=(640, 360)) -> bool:
    try:
        import cv2
    except ImportError:
        return False
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    if not w.isOpened():
        return False
    n = int(seconds * fps)
    if mode == "v2a":
        rng = np.random.default_rng(7)
        base = rng.integers(0, 255, (size[1], 2 * size[0], 3)).astype(
            np.float32)
        base = cv2.GaussianBlur(base, (0, 0), 4.0)
        for i in range(n):
            frame = np.clip(np.roll(base, 2 * i, axis=1)[:, : size[0]],
                            0, 255)
            w.write(frame.astype(np.uint8))
    else:
        frame0 = _keyboard_frame(size)
        keys = _key_edges(size[0])
        for i in range(n):
            frame = frame0.copy()
            # a few "pressed" keys sweeping across the keyboard
            for k in ((i // 6) % len(keys), (i // 6 + 7) % len(keys)):
                x0, x1 = keys[k]
                frame[int(size[1] * 0.72):, x0:x1] = (170, 190, 255)
            w.write(frame)
    w.release()
    return os.path.getsize(path) > 0


def _key_edges(width: int, n_keys: int = 28):
    edges = np.linspace(0, width, n_keys + 1).astype(int)
    return [(int(edges[i]) + 1, int(edges[i + 1]) - 1)
            for i in range(n_keys)]


def _keyboard_frame(size) -> np.ndarray:
    """A static keyboard-ish frame: dark body, white keys along the bottom
    band (where the reference's crop boxes expect the keyboard), black keys
    overlaid on the upper half of that band."""
    wpx, hpx = size
    frame = np.full((hpx, wpx, 3), 28, np.uint8)
    top = int(hpx * 0.70)
    frame[top:] = 235                                     # white key band
    for x0, x1 in _key_edges(wpx):
        frame[top:, x0 - 1: x0] = 40                      # key separators
    # black keys: pattern of 2+3 per octave over the upper 60% of the band
    black_h = int((hpx - top) * 0.6)
    keys = _key_edges(wpx)
    for i, (x0, x1) in enumerate(keys):
        if i % 7 in (1, 2, 4, 5, 6) and i + 1 < len(keys):
            bw = max(2, (x1 - x0) // 2)
            cx = x1
            frame[top: top + black_h, cx - bw // 2: cx + bw // 2] = 15
    return frame
