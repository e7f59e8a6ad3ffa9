"""Vocos mel vocoder (charactr/vocos-mel-24khz): log-mel -> 24 kHz audio.

Counterpart of ``v2ap_tpu/models/vocos.py``: an embedding convolution
(k 7), LayerNorm, ConvNeXt-1d blocks (depthwise k 7, LayerNorm, a
pointwise GELU MLP, LayerScale), a final LayerNorm, then the ISTFT head: a
linear layer to log-magnitude and phase, the magnitude clipped at 1e2,
``istft``. Token tensors are (b, frames, dim); the convolutions run on
their NCW transposes.

``istft`` is the JAX package's: the inverse rFFT of each frame
(``torch.fft.irfft``) times the periodic Hann window, overlap-added by
``F.fold``, divided by the float64 sum of squared windows floored at 1e-11
(``_envelope``, rounded to float32) and centre-trimmed to
``(frames - 1) * hop`` samples. It equals ``torch.istft(center=True)``
only away from the trimmed edges, so it is held against JAX's, not
torch's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Conv1d, LayerNorm, Linear
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100            # mel bins
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    sampling_rate: int = 24_000
    layer_norm_eps: float = 1e-6
    dtype: str = "float32"


def vocos_mel_24khz() -> VocosConfig:
    return VocosConfig()


def vocos_tiny_test() -> VocosConfig:
    return VocosConfig(input_channels=8, dim=16, intermediate_dim=32,
                       num_layers=2, n_fft=16, hop_length=4)


@functools.lru_cache(maxsize=8)
def _hann(n_fft: int) -> np.ndarray:
    """``torch.hann_window(n_fft, periodic=True)`` as float32 numpy."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
            ).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _envelope(frames: int, n_fft: int, hop: int) -> np.ndarray:
    """The summed squared windows at each untrimmed output sample, float64,
    floored at 1e-11, as float32."""
    win_sq = _hann(n_fft) ** 2
    env = np.zeros((frames - 1) * hop + n_fft, np.float64)
    for t in range(frames):
        env[t * hop: t * hop + n_fft] += win_sq
    return np.maximum(env, 1e-11).astype(np.float32)


def overlap_add(frames_td: torch.Tensor, hop: int) -> torch.Tensor:
    """(b, frames, n) time-domain frames -> (b, (frames - 1) * hop + n),
    frame t added at offset t * hop."""
    b, frames, n = frames_td.shape
    total = (frames - 1) * hop + n
    out = F.fold(frames_td.transpose(1, 2), output_size=(1, total),
                 kernel_size=(1, n), stride=(1, hop))
    return out.reshape(b, total)


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """complex (b, frames, n_fft // 2 + 1) -> waveform (b, (frames-1)*hop)."""
    frames = spec.shape[1]
    window = torch.from_numpy(_hann(n_fft)).to(spec.device)
    td = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    out = overlap_add(td, hop)
    out = out / torch.from_numpy(_envelope(frames, n_fft, hop)).to(out.device)
    half = n_fft // 2
    return out[:, half: out.shape[1] - half]


class ConvNeXt1dBlock(nn.Module):
    def __init__(self, cfg: VocosConfig, *, dtype, device=None):
        super().__init__()
        self.dwconv = Conv1d(cfg.dim, cfg.dim, 7, padding=3, groups=cfg.dim,
                             dtype=dtype, device=device)
        self.norm = LayerNorm(cfg.dim, cfg.layer_norm_eps, device=device)
        self.pwconv1 = Linear(cfg.dim, cfg.intermediate_dim, dtype=dtype,
                              device=device)
        self.pwconv2 = Linear(cfg.intermediate_dim, cfg.dim, dtype=dtype,
                              device=device)
        self.gamma = nn.Parameter(torch.full((cfg.dim,), 1.0 / cfg.num_layers,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # (b, t, c)
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.norm(h).to(x.dtype)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + h * self.gamma.to(x.dtype)


class Vocos(nn.Module):
    """log-mel (b, frames, n_mels) or (b, n_mels, frames) -> waveform
    (b, (frames - 1) * hop), float32."""

    def __init__(self, cfg: VocosConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or vocos_mel_24khz()
        self.dtype = dtype = getattr(torch, cfg.dtype)
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 7, padding=3,
                            dtype=dtype, device=device)
        self.norm = LayerNorm(cfg.dim, cfg.layer_norm_eps, device=device)
        self.blocks = nn.ModuleList([ConvNeXt1dBlock(cfg, dtype=dtype,
                                                     device=device)
                                     for _ in range(cfg.num_layers)])
        self.final_norm = LayerNorm(cfg.dim, cfg.layer_norm_eps,
                                    device=device)
        self.head = Linear(cfg.dim, cfg.n_fft + 2, dtype=dtype, device=device)

    def backbone(self, mel: torch.Tensor) -> torch.Tensor:
        """(b, frames, n_mels) -> (b, frames, dim), float32."""
        x = self.embed(mel.to(self.dtype).transpose(1, 2)).transpose(1, 2)
        x = self.norm(x).to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.final_norm(x)

    def decode(self, mel: torch.Tensor) -> torch.Tensor:
        if mel.shape[-1] != self.cfg.input_channels:
            mel = mel.transpose(-1, -2)
        out = self.head(self.backbone(mel).to(self.dtype)).float()
        half = self.cfg.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(out[..., :half]), max=1e2)
        phase = out[..., half:]
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft(spec, self.cfg.n_fft, self.cfg.hop_length)

    forward = decode
