"""Host-side video IO: frame decode and the CLIP-stream interpolation index.

A copy of the parts of ``v2ap_tpu/data/video_io.py`` the V2A slice uses.
OpenCV is imported only when a file is decoded; callers that already hold
decoded frames (``frames_cache``) need none.

Interpolation (exact): one conditioning row per ``frame_size`` samples; row
i maps to source frame ``round(t_i / frame_dt)`` clamped, the "nearest frame
at the hop midpoint" rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 24_000
FRAME_SIZE = 320


def read_video_frames(path: str, max_frames: Optional[int] = None,
                      step: int = 1
                      ) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Decode all frames -> (uint8 (t, H, W, 3) RGB, duration_seconds).

    ``step`` > 1 keeps every Nth frame (skipped frames are only grabbed).
    The returned duration always covers the full video. Returns (None, None)
    on decode failure.
    """
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return None, None
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        if step > 1:
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
            n_est = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            if h <= 0 or w <= 0:
                cap.release()
                cap = cv2.VideoCapture(path)      # fall back to full decode
            else:
                arr = np.empty((max((n_est + step - 1) // step, 8),
                                h, w, 3), np.uint8)
                k = i = 0
                while True:
                    if i % step == 0:
                        ok, frame = cap.read()
                        if not ok or frame.shape[:2] != (h, w):
                            break
                        if k == len(arr):         # metadata undercounted
                            arr = np.concatenate([arr, np.empty_like(arr)])
                        cv2.cvtColor(frame, cv2.COLOR_BGR2RGB, dst=arr[k])
                        k += 1
                    else:
                        if not cap.grab():
                            break
                    i += 1
                cap.release()
                if k == 0:
                    return None, None
                arr = arr[:k]
                duration = i / fps if fps > 0 else i / 25.0
                if max_frames is not None and len(arr) > max_frames:
                    idx = np.linspace(0, len(arr) - 1, max_frames).astype(int)
                    arr = arr[idx]
                return arr, float(duration)
        n_est = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        arr = None
        n = 0
        extra = []                      # metadata count wrong/missing
        if n_est > 0 and h > 0 and w > 0:
            arr = np.empty((n_est, h, w, 3), np.uint8)
            while n < n_est:
                ok, frame = cap.read()
                if not ok:
                    break
                if frame.shape[:2] != (h, w):
                    extra.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                    break
                cv2.cvtColor(frame, cv2.COLOR_BGR2RGB, dst=arr[n])
                n += 1
            arr = arr[:n]
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            extra.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if extra:
            arr = (np.concatenate([arr, np.stack(extra)])
                   if arr is not None and n else np.stack(extra))
        if arr is None or not len(arr):
            return None, None
        duration = len(arr) / fps if fps > 0 else len(arr) / 25.0
        if max_frames is not None and len(arr) > max_frames:
            idx = np.linspace(0, len(arr) - 1, max_frames).astype(int)
            arr = arr[idx]
        return arr, float(duration)
    except Exception:
        return None, None


def probe_duration(path: str) -> Optional[float]:
    """Container-metadata duration (no frame decode); None when unknown."""
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return None
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        n = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0
        cap.release()
        return float(n / fps) if fps > 0 and n > 0 else None
    except Exception:
        return None


def interp_indices_clip(num_source: int, duration: float, length: int,
                        start_sample: int = 0, max_sample: Optional[int] = None,
                        sample_rate: int = SAMPLE_RATE,
                        frame_size: int = FRAME_SIZE) -> np.ndarray:
    """Per-hop nearest-source-frame indices for the CLIP stream: row for
    sample i picks frame round((i + hop/2)/sr / (dur/(n-1))) clamped."""
    if max_sample is None:
        max_sample = int(duration * sample_rate)
    samples = np.arange(start_sample, max_sample, frame_size)[:length]
    denom = duration / max(num_source - 1, 1)
    idx = np.round((samples + frame_size // 2) / sample_rate / denom)
    return np.clip(idx.astype(np.int64), 0, num_source - 1)
