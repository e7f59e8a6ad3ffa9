"""Log-mel spectrograms in PyTorch.

Counterpart of ``v2ap_tpu/ops/melspec.py``: the HTK and Slaney mel scales,
``mel_filterbank`` (a numpy table, the same numbers), and the framing that
the JAX package spells out rather than leaving to an STFT routine: reflect
padding of n_fft / 2, strided frames, the periodic Hann window
``np.hanning(n + 1)[:-1]`` (zero-padded to n_fft when shorter), a real FFT,
``|.| ** power``, the filterbank product in float32 and
``log(clip(., floor))``. ``torch.stft``'s own windowing and normalisation
are not used. ``frame_power`` is that framing up to the filterbank; PANN's
and CLAP's front ends (``evaluation/pann.py``, ``models/clap.py``) share it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def hz_to_mel_slaney(f):
    """librosa's default (htk=False) scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    log_step = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0)
                    / log_step, mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)),
                    m * (200.0 / 3.0))


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = 24_000, n_fft: int = 1024, n_mels: int = 100,
                   fmin: float = 0.0, fmax: float | None = None,
                   slaney_norm: bool = False,
                   slaney_scale: bool = False) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft//2+1) float32.
    ``slaney_norm`` applies librosa's area normalisation (TacotronSTFT /
    AudioLDM); without it, torchaudio's ``norm=None``. ``slaney_scale``
    takes librosa's Slaney mel scale instead of HTK's (PANN, CLAP)."""
    fmax = fmax or sr / 2.0
    to_mel = hz_to_mel_slaney if slaney_scale else hz_to_mel
    to_hz = mel_to_hz_slaney if slaney_scale else mel_to_hz
    mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_pts = to_hz(mel_pts)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if slaney_norm:
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None].astype(np.float32)
    return fb


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """The periodic Hann window, centred in n_fft with zeros when shorter."""
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def frame_power(waveform: torch.Tensor, n_fft: int, hop: int,
                win_length: int | None = None, power: float = 1.0,
                center: bool = True) -> torch.Tensor:
    """(b, t) float32 -> (b, frames, n_fft//2+1) float32 ``|rfft| ** power``
    of the windowed frames."""
    win_length = win_length or n_fft
    x = waveform.float()
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    segs = x.unfold(-1, n_fft, hop)                       # (b, frames, n_fft)
    window = torch.from_numpy(hann_window(win_length, n_fft)).to(x.device)
    return torch.fft.rfft(segs * window, dim=-1).abs() ** power


def apply_filterbank(power: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """(b, frames, k) @ fb (m, k)^T -> (b, frames, m) in float32."""
    return power.float() @ torch.from_numpy(fb).to(power.device).T


def tacotron_mel(waveform, sr: int = 16_000, n_fft: int = 1024,
                 hop: int = 160, win_length: int = 1024, n_mels: int = 64,
                 fmin: float = 0.0, fmax: float = 8_000.0):
    """AudioLDM's TacotronSTFT featurisation: Slaney-normalised mel with
    dynamic-range compression log(clip(x, 1e-5)) at 16 kHz / hop 160."""
    return melspectrogram(waveform, sr=sr, n_fft=n_fft, hop=hop,
                          win_length=win_length, n_mels=n_mels, power=1.0,
                          log_floor=1e-5, fmin=fmin, fmax=fmax,
                          slaney_norm=True)


def melspectrogram(
    waveform: torch.Tensor,            # (b, t)
    sr: int = 24_000,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int | None = None,
    n_mels: int = 100,
    power: float = 1.0,
    log_floor: float = 1e-5,
    center: bool = True,
    fmin: float = 0.0,
    fmax: float | None = None,
    slaney_norm: bool = False,
) -> torch.Tensor:
    """-> (b, frames, n_mels) log-mel, float32."""
    mag = frame_power(waveform, n_fft, hop, win_length, power, center)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, slaney_norm)
    return torch.log(torch.clamp(apply_filterbank(mag, fb), min=log_floor))
