"""Host-side audio IO: WAV decode and encode, resampling, normalisation,
max-energy segment selection, length shaping.

A copy of ``v2ap_tpu/data/audio_io.py``: WAVs decode through the host
library (``v2ap_torch.native``: 16-, 24- and 32-bit PCM, 32-bit float,
WAVE_FORMAT_EXTENSIBLE), and a format it does not take through the
standard library's ``wave``; 16-bit PCM out; scipy polyphase resampling to
24 kHz mono; mean removal and peak normalisation to 0.5; the max-energy
window of ``target_frames`` hops, its start found by the library; short
clips padded by repetition.
"""

from __future__ import annotations

import math
import os
import wave
from fractions import Fraction

import numpy as np

from v2ap_torch import native

SAMPLE_RATE = 24_000
HOP_SIZE = 320
TARGET_FRAMES = 750          # 10 s of 75 Hz latent frames


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A WAV file -> (float32 (channels, n), sample rate): through the host
    library, else (a format it does not take) through ``wave``, which reads
    16-, 24- and 32-bit PCM."""
    with open(path, "rb") as f:
        out = native.wav_decode(f.read())
    if out is not None:
        return out
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported wav sample width {width} in {path}")
    return data.reshape(-1, ch).T.copy(), sr


def write_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """float32 (n,) or (channels, n), clipped to [-1, 1] -> 16-bit PCM."""
    if audio.ndim == 1:
        audio = audio[None]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.T.tobytes())


def resample(audio: np.ndarray, sr: int, target_sr: int = SAMPLE_RATE
             ) -> np.ndarray:
    """Polyphase resampling (ch, n) -> (ch, m)."""
    if sr == target_sr:
        return audio
    from scipy.signal import resample_poly
    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(audio, frac.numerator, frac.denominator,
                         axis=-1).astype(np.float32)


def normalize_wav(audio: np.ndarray) -> np.ndarray:
    """Mean removal, then peak normalisation to 0.5."""
    audio = audio - audio.mean()
    audio = audio / (np.abs(audio[0]).max() + 1e-8)
    return (audio * 0.5).astype(np.float32)


def pad_or_repeat(audio: np.ndarray, length: int) -> np.ndarray:
    """Tile short clips to fill ``length`` samples, truncate long ones."""
    n = audio.shape[-1]
    if n >= length:
        return audio[..., :length]
    reps = math.ceil(length / n)
    return np.tile(audio, (1, reps))[..., :length]


def frame_energy(audio: np.ndarray, hop: int = HOP_SIZE) -> np.ndarray:
    """(1, n) -> per-hop mean |x| energies."""
    n = audio.shape[-1] // hop
    return np.abs(audio[0, : n * hop]).reshape(n, hop).mean(axis=1)


def select_max_energy_segment(audio: np.ndarray, target_frames: int,
                              hop: int = HOP_SIZE) -> np.ndarray:
    """The ``target_frames``-hop window of the largest summed hop energy
    of the first channel (the first on a tie), found by the host library;
    shorter clips are padded by repetition."""
    total = audio.shape[-1] // hop
    if total <= target_frames:
        return pad_or_repeat(audio, target_frames * hop)
    start = native.max_energy_start(audio[0], hop, target_frames)
    return audio[..., start * hop: (start + target_frames) * hop]


def max_energy_start_plain(audio: np.ndarray, target_frames: int,
                           hop: int = HOP_SIZE) -> int:
    """The plain version of the library's ``max_energy_start`` (the JAX
    package's numpy path): a prefix sum over the hop energies. The library
    sums in float64 from float32 samples, this in numpy's pairwise order, so
    two windows within rounding of each other may tie differently."""
    total = audio.shape[-1] // hop
    e = frame_energy(audio, hop)
    csum = np.concatenate([[0.0], np.cumsum(e)])
    window = csum[target_frames:] - csum[:-target_frames]   # sums of windows
    return int(np.argmax(window[: total - target_frames + 1]))


def load_training_clip(path: str, target_frames: int = TARGET_FRAMES,
                       val: bool = False,
                       rng: np.random.Generator | None = None,
                       ) -> np.ndarray | None:
    """Decode, mix down to mono, resample to 24 kHz, normalise, then the
    max-energy (train) or leading (val) window of ``target_frames`` hops.
    Returns (1, n), or None for a file that does not decode or is silent or
    not finite. ``rng`` is unused, as in JAX."""
    try:
        audio, sr = read_wav(path)
    except Exception:
        return None
    audio = audio.mean(axis=0, keepdims=True) if audio.shape[0] > 1 else audio
    audio = resample(audio, sr)
    if not np.isfinite(audio).all() or np.abs(audio).max() < 1e-6:
        return None
    audio = normalize_wav(audio)
    length = target_frames * HOP_SIZE
    if val:
        return pad_or_repeat(audio, length)
    audio = pad_or_repeat(audio, max(length, audio.shape[-1]))
    return select_max_energy_segment(audio, target_frames)
