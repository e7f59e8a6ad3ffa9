"""Multi-head attention with per-head value gating and logit soft-clamping.

Counterpart of ``v2ap_tpu/ops/attention.py``: q/k/v/out projections without
bias (fused qkv for self-attention, split projections for cross-attention),
rotary on q and k of self-attention only, softclamped logits, key-padding
mask, sigmoid per-head output gates computed from the query input. Every
call, self and cross, goes through ``flash_attention_packed`` on the
head-packed projections (K1 in serving, K3-K5 under autograd). In training
(``deterministic=False``) dropout applies to the attention output rows
before the value gates, as in the JAX package (not to the probabilities,
which the flash kernels never materialise). Under tensor parallelism
(``parallel.sharding``) ``heads`` is this rank's and ``tp`` holds the model
group and the first head: the gates take those heads' rows of
``to_v_gates``.
"""

from __future__ import annotations

import torch
from torch import nn

from v2ap_torch.ops.flash_attention import flash_attention_packed
from v2ap_torch.ops.layers import Dropout, Linear
from v2ap_torch.ops.rope import apply_rope


class Attention(nn.Module):
    tp = None
    def __init__(
        self,
        dim: int,
        heads: int,
        dim_head: int,
        *,
        dim_context: int | None = None,
        cross_attention: bool | None = None,
        dropout: float = 0.0,
        gate_value_heads: bool = True,
        softclamp_logits: bool = True,
        softclamp_value: float = 50.0,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        inner = heads * dim_head
        dim_context = dim_context or dim
        self.heads = heads
        self.dim_head = dim_head
        self.softclamp = softclamp_value if softclamp_logits else None
        kw = dict(bias=False, dtype=dtype, device=device)
        if cross_attention is None:
            cross_attention = dim_context != dim
        self.fused_qkv = not cross_attention
        if self.fused_qkv:
            self.to_qkv = Linear(dim, 3 * inner, **kw)
        else:
            self.to_q = Linear(dim, inner, **kw)
            self.to_k = Linear(dim_context, inner, **kw)
            self.to_v = Linear(dim_context, inner, **kw)
        self.to_out = Linear(inner, dim, **kw)
        self.to_v_gates = (Linear(dim, heads, dtype=dtype, device=device)
                           if gate_value_heads else None)
        self.dropout = Dropout(dropout)

    def forward(
        self,
        x: torch.Tensor,                            # (b, n, dim)
        *,
        rotary: torch.Tensor | None = None,         # rope table (>= n, dim_head)
        mask: torch.Tensor | None = None,           # (b, n) key padding (self)
        context: torch.Tensor | None = None,        # (b, nc, dim_context)
        context_mask: torch.Tensor | None = None,   # (b, nc)
        deterministic: bool = True,
    ) -> torch.Tensor:
        has_context = context is not None
        if self.fused_qkv and not has_context:
            qp, kp, vp = self.to_qkv(x).chunk(3, dim=-1)   # packed views
        else:
            if self.fused_qkv:
                raise ValueError("cross-attention requires dim_context-separate "
                                 "projections")
            kv_input = context if has_context else x
            qp, kp, vp = self.to_q(x), self.to_k(kv_input), self.to_v(kv_input)
        h, d = self.heads, self.dim_head
        if rotary is not None and not has_context:
            qp = apply_rope(qp.unflatten(-1, (h, d)), rotary, seq_axis=1).flatten(2)
            kp = apply_rope(kp.unflatten(-1, (h, d)), rotary, seq_axis=1).flatten(2)
        out = flash_attention_packed(qp, kp, vp,
                                     context_mask if has_context else mask,
                                     heads=h, dim_head=d,
                                     softclamp=self.softclamp)
        out = self.dropout(out, deterministic=deterministic)
        if self.to_v_gates is not None:
            gates = torch.sigmoid(self._gates(x))          # (b, n, heads)
            out = (out.unflatten(-1, (h, d)) * gates[..., None]).flatten(2)
        return self.to_out(out)

    def _gates(self, x: torch.Tensor) -> torch.Tensor:
        lin = self.to_v_gates
        if self.tp is None:
            return lin(x)
        from v2ap_torch.parallel.distributed import column_product

        group, h0 = self.tp
        sl = slice(h0, h0 + self.heads)
        dt = lin.dtype
        bias = lin.bias[sl].to(dt) if lin.bias is not None else None
        return column_product(x.to(dt), lin.weight[sl].to(dt), bias, group)
