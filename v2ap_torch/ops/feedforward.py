"""GLU feedforward block: proj(x) -> (v, gate); v * gelu(gate) -> dropout
-> out-proj.

Counterpart of ``v2ap_tpu/ops/feedforward.py`` (exact erf GELU). Dropout
on the GLU hidden applies in training (``deterministic=False``) only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Dropout, Linear


class GLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.proj_in = Linear(dim, inner * 2, dtype=dtype, device=device)
        self.proj_out = Linear(inner, dim, dtype=dtype, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True
                ) -> torch.Tensor:
        v, gate = self.proj_in(x).chunk(2, dim=-1)
        h = self.dropout(v * F.gelu(gate), deterministic=deterministic)
        return self.proj_out(h)
