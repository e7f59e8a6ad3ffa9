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
(zero rows and columns add nothing to an int32 sum); nothing falls back to
a floating-point product.

Two paths compute the same bits:

  * the plain chain (``int8_linear_reference``: ``quantize_rows``,
    ``int8_matmul``, ``dequantize``), about 17 PyTorch kernels a call; a
    CPU tensor takes it, and it is the kernels' oracle;
  * on a CUDA tensor, ``int8_linear`` launches the hand-written kernels of
    ``v2ap_torch/csrc/quantize.cu`` around ``torch._int_mm``: Q1
    (``quantize_rows_padded``) on the activations and on the weight, each
    writing its codes straight into the zero-padded buffer the GEMM takes,
    and Q2 (``dequantize_padded``) from the int32 sums to the output. It
    raises on what they do not take (another dtype, mismatched shapes or
    devices, a call that needs a gradient), with no fallback. The kernels
    synchronise nothing and the wrapper allocates with ``torch.empty``, so
    the path runs inside a captured CUDA graph (the int8 CFM's sampler).
    ``launch_counts["int8_quantize"]`` and ``["int8_dequantize"]`` count the
    launches (``ops.flash_attention.count_launch``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2ap_torch.ops import flash_attention as fa

QUANT_BOUND = 127.5                 # AQT IntSymmetric(8 bits, preserve_zero)
CLIP_BOUND = 127.0                  # its forward clip bound before rounding
_MIN_ROWS = 17                      # torch._int_mm: more than 16 rows
_WIDTH_STEP = 8                     # torch._int_mm: k and n multiples of 8
_DTYPES = (torch.float32, torch.bfloat16)
_VEC_BYTES = 16                     # the kernels' vector loads and stores


# --------------------------------------------------------------------------- #
# Plain chain — the CPU path and the kernels' oracle
# --------------------------------------------------------------------------- #


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


def _padded(n: int) -> int:
    return -(-n // _WIDTH_STEP) * _WIDTH_STEP


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
    mp, kp, np_ = max(m, _MIN_ROWS), _padded(k), _padded(n)
    out = torch._int_mm(_pad_to(a, mp, kp), _pad_to(b, np_, kp).t())
    return out[:m, :n]


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AQT's dequantize of the (m, n) int32 sums in the scales' dtype: the
    sums cast to it, times the row scales ``sx`` (m, 1), times the column
    scales ``sw`` (n, 1), plus ``bias`` (n,)."""
    y = acc.to(sx.dtype) * sx
    y = y * sw.reshape(1, -1)
    if bias is not None:
        y = y + bias
    return y


def int8_linear_reference(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``int8_linear``'s function as the plain chain of PyTorch ops."""
    lead = x.shape[:-1]
    qx, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    qw, sw = quantize_rows(weight)
    y = dequantize(int8_matmul(qx, qw), sx, sw, bias)
    return y.reshape(*lead, weight.shape[0])


# --------------------------------------------------------------------------- #
# CUDA kernels: checks and launch
# --------------------------------------------------------------------------- #

def _vector_rows(x: torch.Tensor) -> bool:
    """Whether Q1 may read the rows of the 2-D ``x`` in 16-byte vectors: a
    contiguous last dim, a width of whole vectors, 16-byte aligned base and
    row stride. Other views, and rows wider than 8 warps hold in registers,
    take its scalar route."""
    step = x.element_size()
    return (x.stride(-1) == 1 and x.shape[-1] * step % _VEC_BYTES == 0
            and x.data_ptr() % _VEC_BYTES == 0
            and (x.shape[0] == 1 or x.stride(0) * step % _VEC_BYTES == 0))


def _vector_bias(bias: Optional[torch.Tensor], n: int,
                 element_size: int) -> bool:
    """Whether Q2 writes its rows in 16-byte vectors: a width of whole
    vectors and a bias (if any) contiguous and 16-byte aligned."""
    return n * element_size % _VEC_BYTES == 0 and (
        bias is None or (bias.stride(0) == 1
                         and bias.data_ptr() % _VEC_BYTES == 0))


def _check_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> None:
    """Raise unless the kernels take the call: float32 or bfloat16 ``x``
    (..., k), ``weight`` (n, k) and ``bias`` (n,) or None, of one dtype, on
    one device, k and n nonzero, and no gradient needed (the kernels
    compute none)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the int8 kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    if weight.dtype != x.dtype or (bias is not None
                                   and bias.dtype != x.dtype):
        raise TypeError(f"int8 Linear: x {x.dtype}, weight {weight.dtype}, "
                        f"bias {None if bias is None else bias.dtype} differ")
    if (weight.dim() != 2 or x.dim() == 0 or x.shape[-1] != weight.shape[1]
            or 0 in weight.shape
            or (bias is not None and tuple(bias.shape) != weight.shape[:1])):
        raise ValueError(f"int8 Linear: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} do "
                         f"not make a (..., k) x (n, k) product")
    tensors = (x, weight) if bias is None else (x, weight, bias)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"int8 Linear inputs on different devices: "
                         f"{devices}")
    if fa._needs_grad(*tensors):
        raise RuntimeError("int8 Linear: the int8 kernels compute no "
                           "gradient; call it without autograd")


def quantize_rows_padded(x: torch.Tensor, rows: int) -> tuple:
    """Q1: ``quantize_rows`` of the 2-D CUDA ``x`` (m, k), the codes in a
    zero-padded (rows, k rounded up to 8) int8 buffer (rows >= m), the
    scales (m, 1) in x's dtype."""
    m, k = x.shape
    kp = _padded(k)
    codes = torch.empty(rows, kp, dtype=torch.int8, device=x.device)
    scale = torch.empty(m, 1, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fa._library().v2ap_int8_quantize(
            x.dtype == torch.bfloat16, _vector_rows(x), x.data_ptr(),
            codes.data_ptr(), scale.data_ptr(), m, rows, x.stride(0),
            x.stride(1), k, kp, fa._stream(x))
    fa.raise_on_launch_error(err, "int8 quantize kernel")
    fa.count_launch("int8_quantize")
    return codes, scale


def dequantize_padded(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                      bias: Optional[torch.Tensor], m: int, n: int
                      ) -> torch.Tensor:
    """Q2: ``dequantize`` of the first (m, n) of the contiguous int32 sums
    ``acc`` (>= m, >= n) into a new (m, n) tensor in the scales' dtype."""
    out = torch.empty(m, n, dtype=sx.dtype, device=acc.device)
    if not m:
        return out
    with torch.cuda.device(acc.device):
        err = fa._library().v2ap_int8_dequantize(
            sx.dtype == torch.bfloat16,
            _vector_bias(bias, n, out.element_size()), acc.data_ptr(),
            sx.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m,
            acc.stride(0), 0 if bias is None else bias.stride(0), n,
            fa._stream(acc))
    fa.raise_on_launch_error(err, "int8 dequantize kernel")
    fa.count_launch("int8_dequantize")
    return out


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #

def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b through AQT's int8 product: ``x`` (..., k) and
    ``weight`` (n, k) in the compute dtype, ``bias`` (n,) in it or None.
    The plain chain on the CPU; Q1, ``torch._int_mm`` and Q2 on CUDA."""
    if not x.is_cuda:
        return int8_linear_reference(x, weight, bias)
    _check_linear(x, weight, bias)
    lead, n = x.shape[:-1], weight.shape[0]
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    qx, sx = quantize_rows_padded(x2, max(m, _MIN_ROWS))
    qw, sw = quantize_rows_padded(weight, _padded(n))
    acc = torch._int_mm(qx, qw.t())
    return dequantize_padded(acc, sx, sw, bias, m, n).reshape(*lead, n)


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
