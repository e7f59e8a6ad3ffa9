"""RMSNorm, time-conditioned AdaptiveRMSNorm and the AdaLN-Zero gate: the
plain PyTorch versions and the wrappers over the hand-written CUDA kernels
of ``v2ap_torch/csrc/norms.cu``.

Counterpart of ``v2ap_tpu/ops/norms.py``. Norms run in float32 whatever the
compute dtype and return the input's dtype.

Two fused kernels, built into the flash-attention kernels' library:

  * N1 ``rms_norm``: ``x / sqrt(max(sum x^2, eps^2)) * sqrt(d) * gain`` in
    one pass, the gain per channel (``RMSNorm``'s ``g``) or per batch row
    (``AdaptiveRMSNorm``'s ``1 + gamma``);
  * N2 ``gated_residual``: ``x + AdaLNZero(branch)``, the gated branch
    rounded to the input's dtype before the sum, as the plain version
    rounds it.

Each runs on a CUDA tensor when no gradient is needed (serving, the eval
step, reference forwards under ``no_grad``); it raises on what it does not
take, with no fallback. On a CPU tensor, and wherever autograd needs the
gradient (training), the plain version runs. ``launch_counts["rms_norm"]``
and ``["gated_residual"]`` count the launches, through a CUDA graph's
replays too (``flash_attention.count_launch``).
"""

from __future__ import annotations

import torch
from torch import nn

from v2ap_torch.ops import flash_attention as fa
from v2ap_torch.ops.layers import Linear

EPS = 1e-12
_DTYPES = (torch.float32, torch.bfloat16)
_VEC_BYTES = 16     # the kernels load and store 16-byte vectors
_WIDTH_STEP = 8     # row widths are multiples of 8 elements


# --------------------------------------------------------------------------- #
# Plain versions — the CPU and autograd path and the kernels' oracle
# --------------------------------------------------------------------------- #

def _l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    # x / max(||x||, eps), with the max inside the sqrt
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def _per_row(gamma: torch.Tensor) -> torch.Tensor:
    """A (b, d) projection as (b, 1, d), broadcast over the sequence."""
    return gamma[:, None, :] if gamma.dim() == 2 else gamma


def rms_norm_reference(x: torch.Tensor, g: torch.Tensor | None = None, *,
                       gamma: torch.Tensor | None = None) -> torch.Tensor:
    """N1's function: the l2-normalised rows of ``x`` times sqrt(d) times
    ``g`` (d,), or times ``1 + gamma`` ((b, d) or (b, 1, d)), in float32,
    returned in x's dtype."""
    normed = _l2_normalize(x.float()) * float(x.shape[-1]) ** 0.5
    if gamma is None:
        return (normed * g).to(x.dtype)
    return (normed * (_per_row(gamma).float() + 1.0)).to(x.dtype)


def _gate(branch: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return (branch.float() * torch.sigmoid(_per_row(gamma).float())
            ).to(branch.dtype)


def gated_residual_reference(x: torch.Tensor, branch: torch.Tensor,
                             gamma: torch.Tensor) -> torch.Tensor:
    """N2's function: ``x + AdaLNZero(branch)`` with the raw projection
    ``gamma``."""
    return x + _gate(branch, gamma)


# --------------------------------------------------------------------------- #
# CUDA kernels: checks and launch
# --------------------------------------------------------------------------- #

def _check_rows(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is what the kernels walk: a float32 or bf16
    (b, n, d) view, d a multiple of 8, with a contiguous last dim and
    16-byte aligned base and row strides."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the norm kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name}: the norm kernels take (b, n, d) rows, "
                         f"got {tuple(x.shape)}")
    if x.shape[-1] % _WIDTH_STEP:
        raise ValueError(f"{name}: row width {x.shape[-1]} is not a multiple "
                         f"of {_WIDTH_STEP}")
    _check_vectors(x, name)


def _check_vectors(t: torch.Tensor, name: str) -> None:
    """Raise unless every row of ``t`` starts on a 16-byte boundary and its
    last dim is contiguous (the kernels' vector loads)."""
    step = t.element_size()
    strides = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.stride(-1) != 1 or t.data_ptr() % _VEC_BYTES or any(
            s * step % _VEC_BYTES for s in strides):
        raise ValueError(f"{name}: the norm kernels load 16-byte vectors, "
                         f"which needs a contiguous last dim and 16-byte "
                         f"aligned rows; shape {tuple(t.shape)}, strides "
                         f"{tuple(t.stride())}")


def _batch_gain(gamma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-batch-row projection of x, (b, d) or (b, 1, d), as f32 (b, d)."""
    b, _, d = x.shape
    if gamma.dim() == 3 and gamma.shape[1] == 1:
        gamma = gamma[:, 0]
    if tuple(gamma.shape) != (b, d):
        raise ValueError(f"gamma {tuple(gamma.shape)} is not a per-batch-row "
                         f"projection of x {tuple(x.shape)}")
    gamma = gamma.float()
    _check_vectors(gamma, "gamma")
    return gamma


def _same_device(*tensors) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"norm kernel inputs on different devices: {devices}")


def _launch_rms_norm(x: torch.Tensor, gain: torch.Tensor,
                     plus_one: bool) -> torch.Tensor:
    _check_rows(x, "x")
    b, n, d = x.shape
    if plus_one:
        gain = _batch_gain(gain, x)
        g_sb = gain.stride(0)
    else:
        if tuple(gain.shape) != (d,):
            raise ValueError(f"g {tuple(gain.shape)} does not match width {d}")
        gain, g_sb = gain.float(), 0
        _check_vectors(gain, "g")
    _same_device(x, gain)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            err = fa._library().v2ap_rms_norm(
                x.dtype == torch.bfloat16, x.data_ptr(), gain.data_ptr(),
                out.data_ptr(), b * n, n, x.stride(0), x.stride(1), g_sb, d,
                plus_one, float(d) ** 0.5, EPS * EPS, fa._stream(x))
        fa.raise_on_launch_error(err, "rms_norm kernel")
        fa.count_launch("rms_norm")
    return out


def _launch_gated_residual(x: torch.Tensor, branch: torch.Tensor,
                           gamma: torch.Tensor) -> torch.Tensor:
    if branch.shape != x.shape or branch.dtype != x.dtype:
        raise ValueError(f"branch {tuple(branch.shape)} {branch.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    _check_rows(x, "x")
    _check_rows(branch, "branch")
    b, n, d = x.shape
    gamma = _batch_gain(gamma, x)
    _same_device(x, branch, gamma)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            err = fa._library().v2ap_gated_residual(
                x.dtype == torch.bfloat16, x.data_ptr(), branch.data_ptr(),
                gamma.data_ptr(), out.data_ptr(), b * n, n, x.stride(0),
                x.stride(1), branch.stride(0), branch.stride(1),
                gamma.stride(0), d, fa._stream(x))
        fa.raise_on_launch_error(err, "gated_residual kernel")
        fa.count_launch("gated_residual")
    return out


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, g: torch.Tensor | None = None, *,
             gamma: torch.Tensor | None = None) -> torch.Tensor:
    """``rms_norm_reference``'s function; N1 on a CUDA tensor that needs no
    gradient."""
    gain = g if gamma is None else gamma
    if not x.is_cuda or fa._needs_grad(x, gain):
        return rms_norm_reference(x, g, gamma=gamma)
    return _launch_rms_norm(x, gain, plus_one=gamma is not None)


def gated_residual(x: torch.Tensor, branch: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """``gated_residual_reference``'s function; N2 on CUDA tensors that need
    no gradient."""
    if not x.is_cuda or fa._needs_grad(x, branch, gamma):
        return gated_residual_reference(x, branch, gamma)
    return _launch_gated_residual(x, branch, gamma)


class RMSNorm(nn.Module):
    """l2-normalize * sqrt(dim) * learned gain."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.g)


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose gain is (1 + W·cond), W zero-initialised.

    ``gamma`` may be the precomputed raw projection (the transformer fuses
    every layer's projections into one matmul); the (+1) happens here.
    """

    def __init__(self, dim: int, dim_condition: int | None = None, *,
                 device=None):
        super().__init__()
        self.to_gamma = Linear(dim_condition or dim, dim, bias=False,
                               zero_init=True, device=device)

    def forward(self, x: torch.Tensor, *, condition: torch.Tensor | None = None,
                gamma: torch.Tensor | None = None) -> torch.Tensor:
        if gamma is None:
            gamma = self.to_gamma(condition.float())
        return rms_norm(x, gamma=gamma)


class AdaLNZero(nn.Module):
    """Post-branch sigmoid gate conditioned on time; bias init -2."""

    def __init__(self, dim: int, dim_condition: int | None = None,
                 init_bias_value: float = -2.0, *, device=None):
        super().__init__()
        self.to_gamma = Linear(dim_condition or dim, dim, zero_init=True,
                               bias_value=init_bias_value, device=device)

    def _gamma(self, condition, gamma):
        if gamma is not None:
            return gamma
        if condition.dim() == 2:
            condition = condition[:, None, :]
        return self.to_gamma(condition.float())

    def forward(self, x: torch.Tensor, *, condition: torch.Tensor | None = None,
                gamma: torch.Tensor | None = None) -> torch.Tensor:
        return _gate(x, self._gamma(condition, gamma))

    def residual(self, x: torch.Tensor, branch: torch.Tensor, *,
                 condition: torch.Tensor | None = None,
                 gamma: torch.Tensor | None = None) -> torch.Tensor:
        """``x + self(branch, ...)``; N2 on the card."""
        return gated_residual(x, branch, self._gamma(condition, gamma))
