"""Counterparts of the flax.nnx built-in layers the JAX package uses, with
nnx's dtype semantics: parameters are float32, and ``dtype`` is the compute
dtype that inputs and parameters are cast to before the op (so
``Linear(dtype=torch.bfloat16)`` behaves as
``nnx.Linear(dtype=bf16, param_dtype=f32)``). Initialisers follow nnx's
defaults; weights loaded from the JAX package replace them
(``v2ap_torch.utils.convert``). ``Dropout`` is ``nnx.Dropout``;
``Conv2d``, ``Conv1d``, ``GroupNorm`` and ``BatchNorm2d`` are ``nnx.Conv``,
``nnx.GroupNorm`` and ``nnx.BatchNorm`` in PyTorch's NCHW / NCW layouts
(``BatchNorm2d`` in training updates its running statistics as flax
does)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.utils.quantize import int8_linear


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """nnx's default kernel init: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class Linear(nn.Module):
    """y = x W^T + b computed in ``dtype``; W stored (out, in) in float32.
    ``int8`` (set by ``utils.quantize.quantize_linears_int8``) runs the
    product as AQT's int8 one on the same stored weights. ``tp`` (set by
    ``parallel.sharding.shard_model``) runs it tensor-parallel on this
    rank's shard of W."""

    int8 = False
    tp = None

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
        if self.tp is not None:
            return self.tp(self, x)
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        if self.int8:
            return int8_linear(x.to(dt), self.weight.to(dt), bias)
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
    (out, in / groups, kh, kw) in float32. ``groups`` is nnx's
    ``feature_group_count`` (``groups == in == out``: depthwise)."""

    def __init__(self, in_features: int, out_features: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // groups, kernel, kernel,
            device=device))
        lecun_normal_(self.weight, in_features // groups * kernel * kernel)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=self.stride,
                        padding=self.padding, groups=self.groups)


class Conv1d(nn.Module):
    """nnx.Conv over 1D inputs in PyTorch's NCW layout: input and weight
    cast to ``dtype``, symmetric padding, dilation, ``groups`` as nnx's
    ``feature_group_count``; weight stored (out, in / groups, k) in
    float32."""

    def __init__(self, in_features: int, out_features: int, kernel: int, *,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // groups, kernel, device=device))
        lecun_normal_(self.weight, in_features // groups * kernel)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv1d(x.to(dt), self.weight.to(dt), bias,
                        stride=self.stride, padding=self.padding,
                        dilation=self.dilation, groups=self.groups)


class GroupNorm(nn.Module):
    """nnx.GroupNorm over the channels (dim 1) of an NC... input, computed
    and returned in float32."""

    def __init__(self, num_features: int, num_groups: int, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class BatchNorm2d(nn.Module):
    """nnx.BatchNorm(dtype=f32) over the channels of NCHW inputs, computed
    and returned in float32 (float64 inputs stay float64, as flax promotes
    to at least float32): (x - mean) * rsqrt(var + eps) * scale + bias.

    ``train=False`` takes the running statistics (``use_running_average``).
    ``train=True`` takes the batch's: the mean and the biased variance
    E[x^2] - E[x]^2, clipped at 0, in float32 (flax's fast variance, its
    two means accumulated in float64 and rounded to float32), and
    moves the running statistics towards them as flax does, ``r = momentum
    * r + (1 - momentum) * batch`` with flax's momentum 0.99 and that biased
    variance (``F.batch_norm(training=True)`` would use momentum 0.1 and
    the unbiased variance). The gradient flows through the batch
    statistics, not into the running ones."""

    MOMENTUM = 0.99                     # flax's default

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)   # as flax: >= f32
        x = x.to(dt)
        if not train:
            return F.batch_norm(x, self.running_mean.to(dt),
                                self.running_var.to(dt), self.weight.to(dt),
                                self.bias.to(dt), training=False,
                                eps=self.eps)
        # E[x] and E[x^2] summed in float64, then rounded: a float32 sum
        # over b*h*w values loses the low bits that E[x^2] - E[x]^2 keeps
        n = x.numel() // x.shape[1]
        mean = (x.sum(dim=(0, 2, 3), dtype=torch.float64) / n).to(dt)
        mean2 = ((x * x).sum(dim=(0, 2, 3), dtype=torch.float64) / n).to(dt)
        var = (mean2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean.to(dt)
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var.to(dt)
                                   + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias.to(dt)[:, None, None])


class Dropout(nn.Module):
    """nnx.Dropout: in training (``deterministic=False``) keep each value
    with probability 1 - rate and scale the kept ones by 1 / (1 - rate).
    The keep-mask is drawn from ``generator``, an explicit seeded
    ``torch.Generator`` on the model's device (the owning model sets it);
    with ``generator=None`` the device's default generator is used. Under
    a mesh (``parallel.sharding.shard_model``) ``rows`` and ``cols`` are
    (ranks, this rank's index) over the data and model axes: the mask is
    drawn at the global shape, ``ranks`` times the local rows and columns,
    and this rank takes its block of each, the unsharded model's mask."""

    rows = cols = (1, 0)

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
        (nr, ir), (nc, ic) = self.rows, self.cols
        b, c = x.shape[0], x.shape[-1]
        shape = (nr * b,) + tuple(x.shape[1:-1]) + (nc * c,)
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep_prob
        if nr > 1 or nc > 1:
            keep = keep.narrow(0, ir * b, b).narrow(-1, ic * c, c)
        return torch.where(keep, x / keep_prob, 0.0)
