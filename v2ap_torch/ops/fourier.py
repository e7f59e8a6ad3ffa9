"""Random-Fourier time embedding + time-conditioning MLP.

Counterpart of ``v2ap_tpu/ops/fourier.py``:
  fourier(x) = [x, sin(2π·x·w), cos(2π·x·w)] with a fixed gaussian w,
  time_mlp   = SiLU(Linear(dim+1 -> dim)(fourier(t))), all float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Linear


class RandomFourierEmbed(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        if dim % 2:
            raise ValueError(f"dim must be even, got {dim}")
        # fixed projection: a buffer, not a parameter
        self.register_buffer("weights", torch.randn(dim // 2, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        freqs = x[:, None] * self.weights[None, :] * 2.0 * math.pi
        return torch.cat([x[:, None], torch.sin(freqs), torch.cos(freqs)],
                         dim=-1)


class TimeCondMLP(nn.Module):
    """times (b,) -> conditioning vector (b, dim)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.fourier = RandomFourierEmbed(dim, device=device)
        self.proj = Linear(dim + 1, dim, device=device)

    def forward(self, times: torch.Tensor) -> torch.Tensor:
        return F.silu(self.proj(self.fourier(times)))
