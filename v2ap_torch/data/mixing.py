"""A-weighted gain-matched waveform mixing augmentation.

A copy of ``v2ap_tpu/data/mixing.py`` (numpy): two clips are mixed with a
ratio r whose effective amplitudes are equalised by their A-weighted
perceptual gains; captions concatenate with " and ".
"""

from __future__ import annotations

import numpy as np


def a_weight_db(fs: int, n_fft: int, min_db: float = -80.0) -> np.ndarray:
    freq = np.linspace(0, fs // 2, n_fft // 2 + 1)
    f2 = np.square(freq)
    f2[0] = 1.0
    w = 2.0 + 20.0 * (
        2 * np.log10(12194.0) + 2 * np.log10(f2)
        - np.log10(f2 + 12194.0 ** 2)
        - np.log10(f2 + 20.6 ** 2)
        - 0.5 * np.log10(f2 + 107.7 ** 2)
        - 0.5 * np.log10(f2 + 737.9 ** 2)
    )
    return np.maximum(w, min_db)


def perceptual_gain_db(sound: np.ndarray, fs: int, min_db: float = -80.0) -> float:
    """Max A-weighted frame power in dB; vectorised over frames."""
    n_fft = {16000: 2048, 44100: 4096, 24000: 3072}.get(fs)
    if n_fft is None:
        raise ValueError(f"unsupported sample rate {fs}")
    stride = n_fft // 2
    n = (len(sound) - n_fft) // stride + 1
    if n <= 0:
        return min_db
    idx = np.arange(n)[:, None] * stride + np.arange(n_fft)[None, :]
    frames = sound[idx] * np.hanning(n_fft + 1)[:-1]
    spec = np.fft.rfft(frames, axis=-1)
    power = np.abs(spec) ** 2
    weighted = power * np.power(10.0, a_weight_db(fs, n_fft) / 10.0)
    gains = np.maximum(weighted.sum(axis=-1), 10.0 ** (min_db / 10.0))
    return float(10.0 * np.log10(gains).max())


def mix_waveforms(s1: np.ndarray, s2: np.ndarray, r: float, fs: int) -> np.ndarray:
    """Mix (1, n) clips with target ratio r in [0,1], gain-matched."""
    g1 = perceptual_gain_db(s1[0], fs)
    g2 = perceptual_gain_db(s2[0], fs)
    t = 1.0 / (1.0 + 10.0 ** ((g1 - g2) / 20.0) * (1.0 - r) / r)
    mixed = (s1 * t + s2 * (1.0 - t)) / np.sqrt(t ** 2 + (1.0 - t) ** 2)
    return mixed.astype(np.float32)


def mix_captions(c1: str, c2: str) -> str:
    def uncap(s: str) -> str:
        return s[:1].lower() + s[1:] if s else s
    return f"{uncap(c1)} and {uncap(c2)}"
