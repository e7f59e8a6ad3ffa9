"""WAV files: read and write.

A copy of ``read_wav`` and ``write_wav`` of ``v2ap_tpu/data/audio_io.py``,
what serving and the merge tools read and write: 16-, 24- and 32-bit PCM
in, 16-bit PCM out, with the standard library's ``wave``. The JAX
package's native decoder (``v2ap_tpu/native``) is not ported; its results
are the same. Resampling, normalisation and segment selection belong to
the training data layer and are not ported yet.
"""

from __future__ import annotations

import os
import wave

import numpy as np

SAMPLE_RATE = 24_000


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A PCM WAV file -> (float32 (channels, n) in [-1, 1], sample rate)."""
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
