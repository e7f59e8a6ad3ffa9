"""Masked depthwise 1-D convolution (voicebox-style positional module).

Counterpart of ``v2ap_tpu/ops/conv.py``: zero masked positions, depthwise
conv (odd kernel, 'same' padding) in the compute dtype, SiLU, re-mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class DepthwiseConv1d(nn.Module):
    def __init__(self, dim: int, kernel_size: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel must be odd for 'same' padding")
        self.dim = dim
        self.kernel_size = kernel_size
        self.dtype = dtype
        bound = math.sqrt(1.0 / kernel_size)
        self.weight = nn.Parameter(torch.empty(dim, 1, kernel_size,
                                               device=device).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        # x: (b, n, d); mask: (b, n) True == keep
        orig_dtype = x.dtype
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        dt = self.dtype
        out = F.conv1d(x.to(dt).transpose(1, 2), self.weight.to(dt),
                       self.bias.to(dt), padding=self.kernel_size // 2,
                       groups=self.dim).transpose(1, 2)
        out = F.silu(out)
        if mask is not None:
            out = out.masked_fill(~mask[..., None], 0.0)
        return out.to(orig_dtype)
