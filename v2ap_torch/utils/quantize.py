"""Serving-time int8 matmuls with AQT's dynamic-range numerics.

Counterpart of ``v2ap_tpu/utils/quantize.py``, which swaps every
``nnx.Linear``'s ``dot_general`` for AQT's int8 one (``dot_general_make(8,
8)``): ``quantize_linears_int8`` sets every ``ops.layers.Linear`` of a
module to its int8 mode in place. Weights stay stored as they are and are
quantized inside each call, so checkpoints and ``load_weights`` do not
change.

The numerics are AQT's (``aqt/jax/v2``), on the tensors in the layer's
compute dtype ``dt`` (bf16 in the serving towers):

  * calibration (``AbsMaxCalibration``): over the contraction axis, per row
    of the activations (per token) and per output channel of the weight,
    ``scale = absmax / 127.5`` in ``dt``, an absmax of 0 taken as 1. XLA
    folds that division by a constant into a product with the float32
    reciprocal of 127.5, and so does the port (the two differ in the last
    bit of some float32 scales);
  * quantizing (``QTensor.quant``, ``IntSymmetric``): ``x * reciprocal(scale)``
    in ``dt``, clipped to +-127, rounded half to even, cast to int8;
  * the product: int8 x int8 accumulated in int32 (``torch._int_mm``,
    cuBLASLt's int8 tensor-core GEMM on the card);
  * dequantizing (``QTensor.dequant``): the int32 sums cast to ``dt``, times
    the activation scale, then times the weight scale, each in ``dt``; the
    bias is added after, as ``nnx.Linear`` adds it.

``torch._int_mm`` on CUDA needs more than 16 rows and a contraction and
output width that are multiples of 8. The codes are zero-padded up to that
on every device (zero rows and columns add nothing to an int32 sum), so the
CPU runs the same code; nothing falls back to a floating-point product.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

QUANT_BOUND = 127.5                 # AQT IntSymmetric(8 bits, preserve_zero)
CLIP_BOUND = 127.0                  # its forward clip bound before rounding
_MIN_ROWS = 17                      # torch._int_mm: more than 16 rows


def quantize_rows(x: torch.Tensor) -> tuple:
    """AQT AbsMax quantization of ``x`` over its last axis: (int8 codes of
    x's shape, scale of shape (..., 1) in x's dtype)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = absmax * (1.0 / QUANT_BOUND)
    inv = torch.reciprocal(scale)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    codes = (x * inv).clamp(-CLIP_BOUND, CLIP_BOUND).round().to(torch.int8)
    return codes, scale


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - c, 0, rows - r))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 x (n, k) int8 -> (m, n) int32, the sums of a @ b.T, with
    the operands zero-padded to what ``torch._int_mm`` takes on the card."""
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = max(m, _MIN_ROWS), -(-k // 8) * 8, -(-n // 8) * 8
    out = torch._int_mm(_pad_to(a, mp, kp), _pad_to(b, np_, kp).t())
    return out[:m, :n]


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b through AQT's int8 product: ``x`` (..., k) and
    ``weight`` (n, k) in the compute dtype, ``bias`` (n,) in it or None."""
    lead = x.shape[:-1]
    qx, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    qw, sw = quantize_rows(weight)
    acc = int8_matmul(qx, qw)
    y = acc.to(x.dtype) * sx
    y = y * sw.reshape(1, -1)
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, weight.shape[0])


def quantize_linears_int8(model: nn.Module, on: bool = True) -> int:
    """Set every ``ops.layers.Linear`` under ``model`` to the int8 product
    (``on=False``: back to the floating-point one) in place; returns the
    number of layers set."""
    from v2ap_torch.ops.layers import Linear

    count = 0
    for module in model.modules():
        if isinstance(module, Linear):
            module.int8 = on
            count += 1
    return count
