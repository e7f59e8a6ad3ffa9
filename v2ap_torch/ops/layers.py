"""Counterparts of the flax.nnx built-in layers the JAX package uses, with
nnx's dtype semantics: parameters are float32, and ``dtype`` is the compute
dtype that inputs and parameters are cast to before the op (so
``Linear(dtype=torch.bfloat16)`` behaves as
``nnx.Linear(dtype=bf16, param_dtype=f32)``). Initialisers follow nnx's
defaults; weights loaded from the JAX package replace them
(``v2ap_torch.utils.convert``). ``Dropout`` is ``nnx.Dropout``;
``Conv2d`` and ``BatchNorm2d`` are ``nnx.Conv`` and ``nnx.BatchNorm`` in
PyTorch's NCHW layout."""

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


class Conv2d(nn.Module):
    """nnx.Conv over 2D inputs with explicit (symmetric) padding, in NCHW:
    input and weight cast to ``dtype``, output in ``dtype``; weight stored
    (out, in, kh, kw) in float32."""

    def __init__(self, in_features: int, out_features: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               kernel, kernel, device=device))
        lecun_normal_(self.weight, in_features * kernel * kernel)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=self.stride,
                        padding=self.padding)


class BatchNorm2d(nn.Module):
    """nnx.BatchNorm(use_running_average=True, dtype=f32) over the channels
    of NCHW inputs: (x - mean) / sqrt(var + eps) * scale + bias from the
    running statistics, computed and returned in float32. The statistics
    are never updated, in training too (JAX's Video2Roll runs with
    ``use_running_average`` there as well); scale and bias take
    gradients."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean.float(),
                            self.running_var.float(), self.weight.float(),
                            self.bias.float(), training=False, eps=self.eps)


class Dropout(nn.Module):
    """nnx.Dropout: in training (``deterministic=False``) keep each value
    with probability 1 - rate and scale the kept ones by 1 / (1 - rate).
    The keep-mask is drawn from ``generator``, an explicit seeded
    ``torch.Generator`` on the model's device (the owning model sets it);
    with ``generator=None`` the device's default generator is used."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor, *, deterministic: bool = True
                ) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, 0.0)
