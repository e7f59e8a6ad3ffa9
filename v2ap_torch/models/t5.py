"""T5 text encoder (FLAN-T5 family, encoder only): prompt -> cross-attention
context.

Counterpart of ``v2ap_tpu/models/t5.py``: RMS-only layer norm in float32,
a relative-position-bucket attention bias computed once from layer 0's table
and shared by every layer, unscaled dot-product attention in float32 with
-1e30 on masked keys (not -inf, so a padded query row stays finite), and a
gated-GELU feedforward (tanh approximation; ReLU, ungated, for
``gated_act=False``). Masked output rows are zero.

The attention is a plain matmul and softmax, as in the JAX package, where it
never reaches a Pallas kernel. The bucket table is computed on the host in
numpy int64, as JAX does: a float path would round differently at the log
boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Embed, Linear
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32_128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated_act: bool = True          # FLAN: gelu-gated; classic t5: relu non-gated
    dtype: str = "bfloat16"


def flan_t5_large() -> T5Config:
    return T5Config()


def t5_tiny_test() -> T5Config:
    return T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_heads=4, dtype="float32")


class T5LayerNorm(nn.Module):
    """RMS-only layer norm (no mean subtraction, no bias) in float32,
    returned in the input's dtype."""

    def __init__(self, dim: int, eps: float, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket scheme (host side, int64)."""
    ret = np.zeros_like(rel_pos)
    n = num_buckets // 2
    ret += (rel_pos > 0).astype(np.int64) * n
    rel = np.abs(rel_pos)
    max_exact = n // 2
    is_small = rel < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, n - 1)
    ret += np.where(is_small, rel, val_if_large)
    return ret


class T5Attention(nn.Module):
    head0 = 0            # the first head of a tensor-parallel rank

    def __init__(self, cfg: T5Config, has_bias: bool, *, dtype, device=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q = Linear(cfg.d_model, inner, **kw)
        self.k = Linear(cfg.d_model, inner, **kw)
        self.v = Linear(cfg.d_model, inner, **kw)
        self.o = Linear(inner, cfg.d_model, **kw)
        self.heads = cfg.num_heads
        self.d_kv = cfg.d_kv
        self.rel_bias = (Embed(cfg.relative_attention_num_buckets,
                               cfg.num_heads, device=device)
                         if has_bias else None)

    def forward(self, x, mask, pos_bias):
        b, n, _ = x.shape

        def split(t):                   # (b, n, h*d) -> (b, h, n, d)
            return t.view(b, n, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if pos_bias.shape[1] != self.heads:      # this rank's heads
            pos_bias = pos_bias[:, self.head0: self.head0 + self.heads]
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + pos_bias
        if mask is not None:            # T5: no 1/sqrt(d) scaling
            s = s.masked_fill(~mask[:, None, None, :], -1e30)
        out = torch.matmul(torch.softmax(s, dim=-1), v.float())
        return self.o(out.to(x.dtype).transpose(1, 2).reshape(b, n, -1))


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, *, dtype, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.gated = cfg.gated_act
        if cfg.gated_act:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, **kw)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, *, dtype, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln1 = T5LayerNorm(cfg.d_model, eps, device=device)
        self.attn = T5Attention(cfg, has_bias, dtype=dtype, device=device)
        self.ln2 = T5LayerNorm(cfg.d_model, eps, device=device)
        self.ff = T5FF(cfg, dtype=dtype, device=device)

    def forward(self, x, mask, pos_bias):
        x = x + self.attn(self.ln1(x), mask, pos_bias)
        return x + self.ff(self.ln2(x))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or flan_t5_large()
        dtype = getattr(torch, cfg.dtype)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype=dtype,
                           device=device)
        self.blocks = nn.ModuleList(
            [T5Block(cfg, has_bias=(i == 0), dtype=dtype, device=device)
             for i in range(cfg.num_layers)])
        self.final_ln = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                    device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(b, n) token ids -> (b, n, d_model) hidden states."""
        n = input_ids.shape[1]
        pos = np.arange(n)
        # HF computes memory_position - query_position (key minus query)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        bias_emb = self.blocks[0].attn.rel_bias(
            torch.from_numpy(buckets).to(input_ids.device))
        pos_bias = bias_emb.permute(2, 0, 1)[None]         # (1, h, n, n) f32

        x = self.embed(input_ids)
        mask = attention_mask.bool() if attention_mask is not None else None
        for blk in self.blocks:
            x = blk(x, mask, pos_bias)
        x = self.final_ln(x)
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        return x
