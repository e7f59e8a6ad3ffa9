"""Counterparts of the flax.nnx built-in layers the JAX package uses, with
nnx's dtype semantics: parameters are float32, and ``dtype`` is the compute
dtype that inputs and parameters are cast to before the op (so
``Linear(dtype=torch.bfloat16)`` behaves as
``nnx.Linear(dtype=bf16, param_dtype=f32)``). Initialisers follow nnx's
defaults; weights loaded from the JAX package replace them
(``v2ap_torch.utils.convert``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """nnx's default kernel init: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Linear(nn.Module):
    """y = x W^T + b computed in ``dtype``; W stored (out, in) in float32."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False, bias_value: float = 0.0,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, in_features)
        self.bias = (nn.Parameter(torch.full((out_features,), bias_value,
                                             device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Module):
    """nnx.Embed: table lookup, output cast to ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                               device=device))
        nn.init.normal_(self.weight, std=features ** -0.5)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx].to(self.dtype)


class LayerNorm(nn.Module):
    """nnx.LayerNorm(dtype=f32): normalises in float32, returns float32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)
