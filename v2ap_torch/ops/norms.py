"""RMSNorm, time-conditioned AdaptiveRMSNorm and the AdaLN-Zero gate.

Counterpart of ``v2ap_tpu/ops/norms.py``. Norms run in float32 whatever the
compute dtype and return the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from v2ap_torch.ops.layers import Linear


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # x / max(||x||, eps), with the max inside the sqrt
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


class RMSNorm(nn.Module):
    """l2-normalize * sqrt(dim) * learned gain."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = float(dim) ** 0.5
        self.g = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _l2_normalize(x.float()) * self.scale * self.g
        return out.to(x.dtype)


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose gain is (1 + W·cond), W zero-initialised.

    ``gamma`` may be the precomputed raw projection (the transformer fuses
    every layer's projections into one matmul); the (+1) happens here.
    """

    def __init__(self, dim: int, dim_condition: int | None = None, *,
                 device=None):
        super().__init__()
        self.scale = float(dim) ** 0.5
        self.to_gamma = Linear(dim_condition or dim, dim, bias=False,
                               zero_init=True, device=device)

    def forward(self, x: torch.Tensor, *, condition: torch.Tensor | None = None,
                gamma: torch.Tensor | None = None) -> torch.Tensor:
        normed = _l2_normalize(x.float()) * self.scale
        if gamma is None:
            gamma = self.to_gamma(condition.float())
        if gamma.dim() == 2:
            gamma = gamma[:, None, :]
        return (normed * (gamma.float() + 1.0)).to(x.dtype)


class AdaLNZero(nn.Module):
    """Post-branch sigmoid gate conditioned on time; bias init -2."""

    def __init__(self, dim: int, dim_condition: int | None = None,
                 init_bias_value: float = -2.0, *, device=None):
        super().__init__()
        self.to_gamma = Linear(dim_condition or dim, dim, zero_init=True,
                               bias_value=init_bias_value, device=device)

    def forward(self, x: torch.Tensor, *, condition: torch.Tensor | None = None,
                gamma: torch.Tensor | None = None) -> torch.Tensor:
        if gamma is None:
            if condition.dim() == 2:
                condition = condition[:, None, :]
            gamma = self.to_gamma(condition.float())
        elif gamma.dim() == 2:
            gamma = gamma[:, None, :]
        gate = torch.sigmoid(gamma.float())
        return (x.float() * gate).to(x.dtype)
