"""Plain float32 reference of the FLAN-T5 encoder (RMS layer norm, one
relative-position bias table shared by every layer, unscaled attention,
gated tanh-GELU feed-forward, masked rows zeroed) and of the hash
tokenizer that serving falls back to without tokenizer files."""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import Embed, Linear, softmax_attention


def hash_tokenize(prompts, vocab_size: int, max_len: int = 64):
    """Each lower-cased word -> md5 % (vocab - 2) + 1, then eos (1), zero
    padded to ``max_len``: (ids, mask) int64 (b, max_len)."""
    ids = np.zeros((len(prompts), max_len), np.int64)
    mask = np.zeros((len(prompts), max_len), np.int64)
    for i, p in enumerate(prompts):
        words = p.split()[: max_len - 1]
        for j, w in enumerate(words):
            ids[i, j] = int(hashlib.md5(w.lower().encode()).hexdigest(),
                            16) % (vocab_size - 2) + 1
        ids[i, len(words)] = 1
        mask[i, : len(words) + 1] = 1
    return ids, mask


def relative_buckets(n: int, num_buckets: int, max_distance: int):
    """Bidirectional T5 buckets of key - query offsets, (n, n) int64."""
    buckets = np.zeros((n, n), np.int64)
    half = num_buckets // 2
    exact = half // 2
    for q in range(n):
        for k in range(n):
            rel = k - q
            b = half if rel > 0 else 0
            r = abs(rel)
            if r < exact:
                b += r
            else:
                large = exact + int(math.log(r / exact)
                                    / math.log(max_distance / exact)
                                    * (half - exact))
                b += min(large, half - 1)
            buckets[q, k] = b
    return buckets


class T5LayerNorm(nn.Module):
    def __init__(self, d, eps, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d, device=device),
                                   requires_grad=False)

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight


class T5Attention(nn.Module):
    def __init__(self, c, has_bias, *, device=None):
        super().__init__()
        inner = c["num_heads"] * c["d_kv"]
        d = c["d_model"]
        self.q = Linear(d, inner, bias=False, device=device)
        self.k = Linear(d, inner, bias=False, device=device)
        self.v = Linear(d, inner, bias=False, device=device)
        self.o = Linear(inner, d, bias=False, device=device)
        self.heads, self.d_kv = c["num_heads"], c["d_kv"]
        self.rel_bias = (Embed(c["relative_attention_num_buckets"],
                               c["num_heads"], device=device)
                         if has_bias else None)

    def forward(self, x, mask, bias):
        b, n, _ = x.shape

        def split(t):
            return t.view(b, n, self.heads, self.d_kv).transpose(1, 2)

        out = softmax_attention(split(self.q(x)), split(self.k(x)),
                                split(self.v(x)), mask, scale=1.0, bias=bias)
        return self.o(out.transpose(1, 2).reshape(b, n, -1))


class T5FF(nn.Module):
    def __init__(self, c, *, device=None):
        super().__init__()
        if not c["gated_act"]:
            raise ValueError("the reference T5 has FLAN's gated GELU")
        d, f = c["d_model"], c["d_ff"]
        self.wi_0 = Linear(d, f, bias=False, device=device)
        self.wi_1 = Linear(d, f, bias=False, device=device)
        self.wo = Linear(f, d, bias=False, device=device)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5Block(nn.Module):
    def __init__(self, c, has_bias, *, device=None):
        super().__init__()
        eps = c["layer_norm_epsilon"]
        self.ln1 = T5LayerNorm(c["d_model"], eps, device=device)
        self.attn = T5Attention(c, has_bias, device=device)
        self.ln2 = T5LayerNorm(c["d_model"], eps, device=device)
        self.ff = T5FF(c, device=device)

    def forward(self, x, mask, bias):
        x = x + self.attn(self.ln1(x), mask, bias)
        return x + self.ff(self.ln2(x))


class T5Encoder(nn.Module):
    def __init__(self, c: dict, *, device=None):
        super().__init__()
        self.c = c
        self.embed = Embed(c["vocab_size"], c["d_model"], device=device)
        self.blocks = nn.ModuleList([T5Block(c, i == 0, device=device)
                                     for i in range(c["num_layers"])])
        self.final_ln = T5LayerNorm(c["d_model"], c["layer_norm_epsilon"],
                                    device=device)

    def forward(self, ids, mask):
        n = ids.shape[1]
        buckets = torch.from_numpy(relative_buckets(
            n, self.c["relative_attention_num_buckets"],
            self.c["relative_attention_max_distance"])).to(ids.device)
        bias = self.blocks[0].attn.rel_bias(buckets).permute(2, 0, 1)[None]
        x = self.embed(ids)
        for blk in self.blocks:
            x = blk(x, mask, bias)
        return self.final_ln(x).masked_fill(~mask[..., None], 0.0)
