"""Plain float32 building blocks of the reference: the layers of the
V2A / V2P model stack written with nothing but ``torch`` operations.

Every layer computes in float32 whatever the served precision is, and
attention is an explicit softmax over explicit logits. Parameter names
follow the served modules' state-dict names, so one set of tensors loads
into both. Parameters are allocated empty: the benchmark assigns its own
seeded weights (``load_state_dict(..., assign=True)``).

Where a configuration states int8 towers (``quantize_towers``), every
``Linear`` of a tower computes AQT's int8 product instead (``int8_linear``,
set by ``int8_linears``), emulated with exact integer sums:

  * scale = absmax / 127.5 over the contraction axis, per row of the
    activations (per token) and per output channel of the weight, an
    absmax of 0 taken as 1; as XLA compiles AQT, the division is a product
    with the float32 reciprocal of 127.5;
  * codes = ``x * (1 / scale)``, clipped to +-127, rounded half to even;
  * the sums of code products in float64, exact as an int32 sum is;
  * the sums times the activation scale, then the weight scale, then the
    bias added.

AQT computes each of those steps in the layer's compute dtype, bf16 in the
served towers; ``int8_linear(..., dtype=torch.bfloat16)`` rounds each to
it, and the check holds single layers of the program to that
(``benchmark/kept.py``). The reference towers run in float32 throughout,
their int8 steps too: one departure from the served program, which
computes its scales and codes in bf16 from bf16 activations.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30
E4M3_MAX = 448.0


class _Rounding:
    """Whether every product is computed one precision below what the
    configuration states (the correctness control): floating-point
    products' inputs rounded to fp8 e4m3 with one scale a tensor, int8
    products in int4."""
    below = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 on its own amax scale, in float32; unchanged
    outside ``one_precision_below``."""
    if not _Rounding.below:
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def one_precision_below():
    """Inside the block every product is computed one precision below the
    configuration's: floating-point products' inputs (linear, convolution
    and attention operands) rounded by ``fp8``, int8 products in int4
    (AQT's 4-bit bounds: 7.5 and 7)."""
    _Rounding.below = True
    try:
        yield
    finally:
        _Rounding.below = False


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device),
                        requires_grad=False)


def _round_to(t: torch.Tensor, dtype) -> torch.Tensor:
    """float32 ``t`` rounded to ``dtype`` and widened back (none for
    float32)."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def int8_quantize(t: torch.Tensor, bits: int = 8,
                  dtype=torch.float32) -> tuple:
    """AQT's AbsMax quantization of ``t`` over its last axis at ``bits``
    (IntSymmetric, preserve_zero: bound 2^(bits-1) - 0.5, clip one below
    2^(bits-1)), each step rounded to the compute ``dtype``: (integer codes
    as float32, of t's shape; scale (..., 1), float32)."""
    bound = 2.0 ** (bits - 1) - 0.5
    t = _round_to(t.float(), dtype)
    absmax = t.abs().amax(dim=-1, keepdim=True)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = _round_to(absmax * (1.0 / bound), dtype)
    inv = _round_to(1.0 / scale, dtype)
    codes = _round_to(t * inv, dtype).clamp(-bound + 0.5, bound - 0.5).round()
    return codes, scale


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                dtype=torch.float32):
    """y = x W^T + b through AQT's int8 product (int4 inside
    ``one_precision_below``) from ``x`` (..., k), ``weight`` (n, k) and
    ``bias`` (n,) or None, each step rounded to the compute ``dtype``;
    float32."""
    bits = 4 if _Rounding.below else 8
    qx, sx = int8_quantize(x, bits, dtype)
    qw, sw = int8_quantize(weight, bits, dtype)
    acc = _round_to(torch.matmul(qx.double(), qw.double().t()).float(),
                    dtype)
    y = _round_to(_round_to(acc * sx, dtype) * sw.reshape(-1), dtype)
    return y if bias is None else _round_to(y + bias.float(), dtype)


class Linear(nn.Module):
    """y = x W^T + b in float32; ``int8`` (set by ``int8_linears``) runs
    AQT's int8 product instead."""

    int8 = False

    def __init__(self, cin: int, cout: int, *, bias: bool = True,
                 device=None):
        super().__init__()
        self.weight = _param(cout, cin, device=device)
        self.bias = _param(cout, device=device) if bias else None

    def forward(self, x):
        if self.int8:
            return int8_linear(x.float(), self.weight, self.bias)
        return F.linear(fp8(x.float()), fp8(self.weight), self.bias)


def int8_linears(model: nn.Module) -> int:
    """Set every ``Linear`` under ``model`` to AQT's int8 product; returns
    how many were set."""
    layers = [m for m in model.modules() if isinstance(m, Linear)]
    for m in layers:
        m.int8 = True
    return len(layers)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, *, device=None):
        super().__init__()
        self.weight = _param(num, dim, device=device)

    def forward(self, idx):
        return self.weight[idx]


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + self.eps) * self.weight
                + self.bias)


class Conv2d(nn.Module):
    """NCHW convolution with symmetric padding."""

    def __init__(self, cin, cout, kernel, *, stride=1, padding=0, bias=True,
                 groups=1, device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = _param(cout, cin // groups, kernel, kernel,
                             device=device)
        self.bias = _param(cout, device=device) if bias else None

    def forward(self, x):
        return F.conv2d(fp8(x), fp8(self.weight), self.bias,
                        stride=self.stride,
                        padding=self.padding, groups=self.groups)


class BatchNorm2d(nn.Module):
    """Inference batch norm on the running statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim, device=device)
        self.bias = _param(dim, device=device)
        self.register_buffer("running_mean", torch.empty(dim, device=device))
        self.register_buffer("running_var", torch.empty(dim, device=device))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


def softmax_attention(q, k, v, kv_mask=None, *, scale, softclamp=None,
                      bias=None):
    """(b, h, nq, d) x (b, h, nk, d) -> (b, h, nq, d): explicit logits,
    optional tanh soft-clamp and additive bias, -1e30 on masked keys."""
    s = torch.matmul(fp8(q * scale), fp8(k).transpose(-1, -2))
    if softclamp is not None:
        s = torch.tanh(s / softclamp) * softclamp
    if bias is not None:
        s = s + bias
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    return torch.matmul(fp8(torch.softmax(s, dim=-1)), fp8(v))


def rope_table(n: int, dim: int, device=None, base: float = 10_000.0):
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device),
                        inv)
    return torch.cat([freqs, freqs], dim=-1)


def apply_rope(t, freqs):
    """Half-split rotary over the last dim of (b, n, h, d); a table
    narrower than d leaves the tail unrotated."""
    rot = freqs.shape[-1]
    half = rot // 2
    n = t.shape[1]
    f = freqs[-n:, :half][:, None, :]
    x1, x2 = t[..., :half], t[..., half:rot]
    cos, sin = torch.cos(f), torch.sin(f)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      t[..., rot:]], dim=-1)


def l2_normalize(x, eps: float = 1e-12):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps * eps))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = float(dim) ** 0.5
        self.g = _param(dim, device=device)

    def forward(self, x):
        return l2_normalize(x) * self.scale * self.g


class AdaptiveRMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = float(dim) ** 0.5
        self.to_gamma = Linear(dim, dim, bias=False, device=device)

    def forward(self, x, cond):
        return l2_normalize(x) * self.scale * (
            self.to_gamma(cond)[:, None, :] + 1.0)


class AdaLNZero(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.to_gamma = Linear(dim, dim, device=device)

    def forward(self, x, cond):
        return x * torch.sigmoid(self.to_gamma(cond)[:, None, :])


class DepthwiseConv1d(nn.Module):
    """Masked depthwise 'same' conv over (b, n, d), then SiLU, re-masked."""

    def __init__(self, dim: int, kernel: int, *, device=None):
        super().__init__()
        self.kernel = kernel
        self.weight = _param(dim, 1, kernel, device=device)
        self.bias = _param(dim, device=device)

    def forward(self, x, mask):
        keep = mask[..., None]
        x = x.masked_fill(~keep, 0.0)
        out = F.conv1d(fp8(x.transpose(1, 2)), fp8(self.weight), self.bias,
                       padding=self.kernel // 2, groups=x.shape[-1])
        return F.silu(out.transpose(1, 2)).masked_fill(~keep, 0.0)


class GLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, *, device=None):
        super().__init__()
        self.proj_in = Linear(dim, dim * mult * 2, device=device)
        self.proj_out = Linear(dim * mult, dim, device=device)

    def forward(self, x):
        v, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(v * F.gelu(gate))


class RandomFourierEmbed(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.register_buffer("weights", torch.empty(dim // 2, device=device))

    def forward(self, t):
        freqs = t[:, None] * self.weights[None, :] * 2.0 * math.pi
        return torch.cat([t[:, None], torch.sin(freqs), torch.cos(freqs)], -1)


class TimeCondMLP(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.fourier = RandomFourierEmbed(dim, device=device)
        self.proj = Linear(dim + 1, dim, device=device)

    def forward(self, t):
        return F.silu(self.proj(self.fourier(t)))


class Attention(nn.Module):
    """Gated multi-head attention: fused qkv for self-attention, split
    projections for cross-attention, rotary on self-attention, soft-clamped
    logits, a sigmoid gate per head computed from the query input."""

    def __init__(self, dim, heads, dim_head, *, dim_context=None,
                 cross_attention=False, gate_value_heads=True,
                 softclamp=None, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.softclamp = heads, dim_head, softclamp
        self.cross = cross_attention
        if cross_attention:
            self.to_q = Linear(dim, inner, bias=False, device=device)
            self.to_k = Linear(dim_context, inner, bias=False, device=device)
            self.to_v = Linear(dim_context, inner, bias=False, device=device)
        else:
            self.to_qkv = Linear(dim, 3 * inner, bias=False, device=device)
        self.to_out = Linear(inner, dim, bias=False, device=device)
        self.to_v_gates = (Linear(dim, heads, device=device)
                           if gate_value_heads else None)

    def forward(self, x, *, rotary=None, mask=None, context=None,
                context_mask=None):
        h, d = self.heads, self.dim_head
        if context is not None:
            q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
            kv_mask = context_mask
        else:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
            kv_mask = mask
        q, k, v = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        if rotary is not None and context is None:
            q, k = apply_rope(q, rotary), apply_rope(k, rotary)
        out = softmax_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), kv_mask, scale=d ** -0.5,
                                softclamp=self.softclamp).transpose(1, 2)
        if self.to_v_gates is not None:
            out = out * torch.sigmoid(self.to_v_gates(x))[..., None]
        return self.to_out(out.flatten(2))
