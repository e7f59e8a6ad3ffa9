"""Host-side video IO: frame and keyboard-strip decode, and the
interpolation plans of the CLIP and piano streams.

A copy of the parts of ``v2ap_tpu/data/video_io.py`` the serving slices
use, with the streaming reader (``VideoChunkReader``) and the strip-half
pack of the wire modes. OpenCV is imported only when a file is decoded or
frames are turned into strips; callers that already hold decoded frames
and strips (``frames_cache``, ``strips_cache``) need none.

Interpolation: one conditioning row per ``frame_size`` samples; at frame
stride 1 row i maps to source frame ``round(t_i / frame_dt)`` clamped (the
"nearest frame at the hop midpoint" rule), at a larger stride it blends the
two nearest encoded frames. Piano rows sit at ``video_multi * frame_size``
samples, start-aligned, and a strided strip array is blended the same way.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 24_000
FRAME_SIZE = 320


class VideoChunkReader:
    """Streaming decode: yields uint8 RGB chunks of up to ``chunk`` frames,
    so that each chunk goes through the towers while the decoder reads the
    next (``V2AP_STREAM_DECODE=1``). ``duration`` is set once the iterator
    is exhausted; ``failed`` when the frame shape changes mid-stream (as
    ``read_video_frames`` fails on it). Needs cv2 (OpenCV): without it the
    constructor raises."""

    def __init__(self, path: str, chunk: int):
        try:
            import cv2
        except ImportError as exc:
            raise ImportError("VideoChunkReader decodes with cv2 (OpenCV), "
                              "which is not installed; hand decoded frames "
                              "in through frames_cache instead") from exc
        self._cv2 = cv2
        self.chunk = chunk
        self.cap = cv2.VideoCapture(path)
        self.ok = self.cap.isOpened()
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) if self.ok else 0.0
        self.frames_read = 0
        self.failed = False
        self.duration: Optional[float] = None

    def __iter__(self):
        if not self.ok:
            return
        cv2 = self._cv2
        buf = None
        while True:
            if buf is None:
                ok, frame = self.cap.read()
                if not ok:
                    break
                buf = np.empty((self.chunk,) + frame.shape, np.uint8)
                cv2.cvtColor(frame, cv2.COLOR_BGR2RGB, dst=buf[0])
                n = 1
            else:
                n = 0
            while n < self.chunk:
                ok, frame = self.cap.read()
                if not ok:
                    break
                if frame.shape != buf.shape[1:]:
                    self.failed = True
                    break
                cv2.cvtColor(frame, cv2.COLOR_BGR2RGB, dst=buf[n])
                n += 1
            if n == 0 or self.failed:
                break
            self.frames_read += n
            yield buf[:n]
            if n < self.chunk:
                break
            buf = np.empty_like(buf)     # the last chunk may still be in use
        self.cap.release()
        self.duration = (self.frames_read / self.fps if self.fps > 0
                         else self.frames_read / 25.0)


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


def read_video_frames_and_strips(
    path: str, step: int = 1, width: int = 900, height: int = 100,
    strip_step: int = 1,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[float],
           Optional[int]]:
    """One decode pass -> (RGB frames at every ``step``-th frame, grayscale
    ``height x width`` keyboard strips at every ``strip_step``-th frame,
    duration, total source-frame count). Frames neither consumer needs are
    only grabbed. At ``strip_step=1`` the strips equal
    ``piano_preprocess(read_video_frames(path)[0])``. Returns (None, None,
    None, None) on decode failure."""
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return None, None, None, None
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        n_est = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        if h <= 0 or w <= 0:                 # no geometry metadata: decode
            cap.release()                    # everything, strip separately
            frames, duration = read_video_frames(path)
            if frames is None:
                return None, None, None, None
            strips = piano_preprocess(frames[::strip_step], width, height)
            return frames[::step], strips, duration, len(frames)
        rgb = np.empty((max((n_est + step - 1) // step, 8), h, w, 3), np.uint8)
        strips = np.empty((max((n_est + strip_step - 1) // strip_step, 8),
                           height, width), np.uint8)
        gray = np.empty((h, w), np.uint8)    # reused per-frame scratch
        k_rgb = k_strip = i = 0
        while True:
            want_rgb = i % step == 0
            want_strip = i % strip_step == 0
            if not (want_rgb or want_strip):
                if not cap.grab():
                    break
                i += 1
                continue
            ok, frame = cap.read()
            if not ok or frame.shape[:2] != (h, w):
                break
            if want_strip:
                if k_strip == len(strips):   # metadata undercounted
                    strips = np.concatenate([strips, np.empty_like(strips)])
                cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY, dst=gray)
                cv2.resize(gray, (width, height),
                           interpolation=cv2.INTER_LINEAR, dst=strips[k_strip])
                k_strip += 1
            if want_rgb:
                if k_rgb == len(rgb):
                    rgb = np.concatenate([rgb, np.empty_like(rgb)])
                cv2.cvtColor(frame, cv2.COLOR_BGR2RGB, dst=rgb[k_rgb])
                k_rgb += 1
            i += 1
        cap.release()
        if i == 0:
            return None, None, None, None
        duration = i / fps if fps > 0 else i / 25.0
        return rgb[:k_rgb], strips[:k_strip], float(duration), i
    except Exception:
        return None, None, None, None


def piano_preprocess(frames: np.ndarray, width: int = 900, height: int = 100
                     ) -> np.ndarray:
    """RGB frames (t, H, W, 3) -> grayscale keyboard strips (t, height,
    width) as uint8 (the division by 255 happens on the device)."""
    import cv2
    out = np.empty((len(frames), height, width), np.uint8)

    def work(i):
        g = cv2.cvtColor(frames[i], cv2.COLOR_RGB2GRAY)
        out[i] = cv2.resize(g, (width, height),
                            interpolation=cv2.INTER_LINEAR)

    workers = min(8, os.cpu_count() or 1)
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:  # cv2 drops GIL
            list(pool.map(work, range(len(frames))))
    else:
        for i in range(len(frames)):
            work(i)
    return out


def pack_strips_half(strips: np.ndarray) -> np.ndarray:
    """Keyboard strips halved along the key axis (the last dim) by exact
    uint8 pair means, rounding half up: the host side of the strip-half
    shipping mode (``V2AP_SHIP_STRIP_HALF``); the device upsamples back
    (``models.video2roll.upsample_strips_2x``)."""
    assert strips.shape[-1] % 2 == 0, strips.shape
    a = strips[..., 0::2].astype(np.uint16)
    b = strips[..., 1::2].astype(np.uint16)
    return ((a + b + 1) >> 1).astype(np.uint8)


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


def interp_weights_clip(num_source: int, duration: float, length: int,
                        start_sample: int = 0,
                        max_sample: Optional[int] = None,
                        sample_rate: int = SAMPLE_RATE,
                        frame_size: int = FRAME_SIZE
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linear-interpolation plan for frame-strided conditioning
    (``ConditioningConfig.frame_stride`` > 1): per-hop positions over the
    encoded anchor frames as (idx0, idx1, w), blended on the device as
    feats[idx0]*(1-w) + feats[idx1]*w. The anchors are taken to span
    ``duration`` uniformly."""
    if max_sample is None:
        max_sample = int(duration * sample_rate)
    samples = np.arange(start_sample, max_sample, frame_size)[:length]
    denom = duration / max(num_source - 1, 1)
    pos = (samples + frame_size // 2) / sample_rate / denom
    idx0 = np.clip(np.floor(pos).astype(np.int64), 0, num_source - 1)
    idx1 = np.minimum(idx0 + 1, num_source - 1)
    w = np.clip(pos - idx0, 0.0, 1.0).astype(np.float32)
    return idx0, idx1, w


def interp_indices_piano(num_source: int, duration: float, length: int,
                         video_multi: float = 3.0, start_sample: int = 0,
                         max_sample: Optional[int] = None,
                         sample_rate: int = SAMPLE_RATE,
                         frame_size: int = FRAME_SIZE) -> np.ndarray:
    """Frame indices for the piano stream at the video_multi-decimated rate:
    floor(length/video_multi)+1 rows, start-aligned rounding."""
    if max_sample is None:
        max_sample = int(duration * sample_rate)
    step = int(video_multi * frame_size)
    n_rows = int(np.floor(length / video_multi)) + 1
    samples = np.arange(start_sample, max_sample + step, step)[:n_rows]
    denom = duration / max(num_source, 1)
    idx = np.round(samples / sample_rate / denom)
    return np.clip(idx.astype(np.int64), 0, num_source - 1)


def interp_weights_piano(num_source: int, duration: float, length: int,
                         strip_step: int, video_multi: float = 3.0,
                         start_sample: int = 0,
                         max_sample: Optional[int] = None,
                         sample_rate: int = SAMPLE_RATE,
                         frame_size: int = FRAME_SIZE
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lerp plan for roll-rate strips out of a ``strip_step``-strided strip
    array: (i0, i1, w) with ``strided[i0]*(1-w) + strided[i1]*w`` standing
    for the full-rate ``strips[interp_indices_piano(...)]``. Each row first
    resolves to the same full-rate index as ``interp_indices_piano``; rows
    on a decoded anchor, and rows whose two anchors coincide, get w = 0.
    ``num_source`` is the FULL-rate frame count, not the strided one."""
    idx = interp_indices_piano(num_source, duration, length,
                               video_multi=video_multi,
                               start_sample=start_sample,
                               max_sample=max_sample,
                               sample_rate=sample_rate,
                               frame_size=frame_size)
    n_strided = (num_source + strip_step - 1) // strip_step
    f = idx.astype(np.float64) / strip_step
    i0 = np.clip(np.floor(f).astype(np.int64), 0, n_strided - 1)
    i1 = np.minimum(i0 + 1, n_strided - 1)
    w = (f - i0).astype(np.float32)
    w[i1 == i0] = 0.0
    return i0.astype(np.int32), i1.astype(np.int32), w


# --------------------------------------------------------------------------- #
# On-disk feature caches and muxing, in the JAX package's file formats
# --------------------------------------------------------------------------- #

def clip_feature_cache_path(video_path: str, encoder: str = "clip_vit") -> str:
    suffix = {"clip_vit": ".generated.npz",
              "clip_vit2": ".generated.clip_vit2.npz",
              "clip_convnext": ".generated.clip_convnext.npz",
              "dinov2": ".generated.dinov2.npz",
              "mixed": ".generated.mixed.npz"}[encoder]
    return video_path.replace(".mp4", suffix)


def piano_frames_cache_path(video_path: str) -> str:
    return video_path.replace(".mp4", ".generated_frames_raw.2.npz")


def piano_roll_cache_path(video_path: str) -> str:
    """Roll-probability cache: the (n, notes) roll Video2Roll gave."""
    return video_path.replace(".mp4", ".generated_roll.npz")


def save_feature_cache(path: str, features: np.ndarray, duration: float,
                       tag: Optional[str] = None) -> None:
    """``np.savez(path, features, duration[, tag=...])``; ``tag`` records
    the numerics that produced the features so that a mode switch cannot
    serve stale entries. A directory that cannot be written skips the
    cache."""
    try:
        if tag is None:
            np.savez(path, features, duration)
        else:
            np.savez(path, features, duration, tag=np.asarray(tag))
    except OSError:
        pass


def load_feature_cache(path: str, tag: Optional[str] = None
                       ) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """(features, duration), or (None, None) when the file is missing or,
    with ``tag`` given, was written under another tag (or none).
    ``tag=None`` accepts any entry (the precision-independent raw strips)."""
    if not os.path.exists(path):
        return None, None
    data = np.load(path)
    if tag is not None:
        stored = str(data["tag"]) if "tag" in data.files else None
        if stored != tag:
            return None, None
    return data["arr_0"], float(data["arr_1"])


def mux_audio_onto_video(video_path: str, audio: np.ndarray, sr: int,
                         out_path: str) -> bool:
    """Write the audio to ``<out_path stem>.wav``, then put it onto the
    video with ffmpeg when one is installed. Returns whether ``out_path``
    was written; without ffmpeg only the wav is."""
    import shutil
    import subprocess

    from v2ap_torch.data.audio_io import write_wav

    ffmpeg = shutil.which("ffmpeg")
    wav_path = os.path.splitext(out_path)[0] + ".wav"
    write_wav(wav_path, audio, sr)
    if ffmpeg is None:
        return False
    cmd = [ffmpeg, "-y", "-i", video_path, "-i", wav_path, "-c:v", "copy",
           "-map", "0:v:0", "-map", "1:a:0", "-shortest", out_path]
    return subprocess.run(cmd, capture_output=True).returncode == 0
