"""The int8 ``Linear``'s kernel wrappers in ``v2ap_torch/utils/quantize.py``
on the CPU: the plain chain the CPU takes, the per-element formulas the
quantize (Q1) and dequantize (Q2) kernels compute, the checks the wrapper
makes before a launch, the routes it picks, and the launch counters. The
kernels themselves run in ``tests/test_torch_cuda.py``."""

import pytest
import torch

from benchmark import faults
from v2ap_torch.ops import flash_attention as fa
from v2ap_torch.ops import layers
from v2ap_torch.ops.layers import Linear
from v2ap_torch.utils import quantize as q

DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


def _old_chain(x, weight, bias):
    """The int8 product as the port computed it before the kernels, written
    out: AbsMax codes per row of x and of the weight, the padded
    ``torch._int_mm``, then the dequantize in the compute dtype."""
    def codes(t):
        a = t.abs().amax(dim=-1, keepdim=True)
        a = torch.where(a == 0, torch.ones_like(a), a)
        s = a * (1.0 / 127.5)
        inv = torch.reciprocal(s)
        inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
        return (t * inv).clamp(-127.0, 127.0).round().to(torch.int8), s

    k = x.shape[-1]
    qx, sx = codes(x.reshape(-1, k))
    qw, sw = codes(weight)
    m, n = qx.shape[0], qw.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.nn.functional.pad(qx, (0, kp - k, 0, max(m, 17) - m))
    b = torch.nn.functional.pad(qw, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a, b.t())[:m, :n]
    y = acc.to(x.dtype) * sx * sw.reshape(1, -1)
    if bias is not None:
        y = y + bias
    return y.reshape(*x.shape[:-1], n)


def _spread(shape, seed, dtype):
    """Values over many binades, a zero row, a row with one huge value."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=gen) * torch.exp2(
        torch.randint(-20, 12, shape[:-1] + (1,), generator=gen).float())
    t[0] = 0.0
    t[-1, 1] = 3e4
    return t.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,k,n,bias", [
    ((2,), 64, 48, True), ((16,), 40, 51, True), ((37,), 96, 51, False),
    ((2, 9), 1664, 64, True), ((3, 5), 1663, 1280, True)],
    ids=["m2", "m16_k40_n51", "n51_nobias", "3d_bigg_k", "k1663"])
def test_cpu_path_is_the_plain_chain(dtype, lead, k, n, bias):
    """``Linear(int8)`` on CPU tensors gives the old chain's bits (m <= 16,
    k and n off the multiple of 8, 3-D inputs, with and without a bias)
    and launches nothing."""
    torch.manual_seed(k + n)
    lin = Linear(k, n, bias=bias, dtype=dtype, device="cpu")
    with torch.no_grad():
        if bias:
            lin.bias.normal_()
    q.quantize_linears_int8(lin)
    x = _spread(lead + (k,), k, torch.float32).reshape(*lead, k)
    before = dict(fa.launch_counts)
    with torch.no_grad():
        got = lin(x)
    want = _old_chain(x.to(dtype), lin.weight.to(dtype),
                      lin.bias.to(dtype) if bias else None)
    assert got.dtype == dtype and got.shape == lead + (n,)
    assert torch.equal(got, want)
    assert torch.equal(q.int8_linear_reference(
        x.to(dtype), lin.weight.to(dtype),
        lin.bias.to(dtype) if bias else None), want)
    assert fa.launch_counts == before


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """A float32 tensor rounded to ``dtype`` and back: the kernels'
    rounding of each step."""
    return t.to(dtype).float()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_q1_formula_is_quantize_rows(dtype, seed):
    """Q1's per-row formula, one float32 operation a step rounded to the
    dtype (scale = T(absmax * f32(1/127.5)), inv = T(1 / scale) by true
    division, an infinite inv 1, codes = rint(clamp(T(x * inv)))), equals
    ``quantize_rows`` bit for bit: zero rows, subnormal rows (whose inv is
    infinite), rows of one huge value, values over many binades."""
    x = _spread((64, 200), seed, dtype)
    x[1] = 0.0
    x[1, 7] = torch.finfo(dtype).tiny / 4       # a subnormal absmax
    x[2, :3] = torch.tensor([126.75, -127.25, 0.5])
    xf = x.float()
    absmax = xf.abs().amax(-1, keepdim=True)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = _round(absmax * torch.tensor(1.0 / 127.5, dtype=torch.float32),
                   dtype)
    inv = _round(torch.tensor(1.0) / scale, dtype)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    codes = torch.round(_round(xf * inv, dtype).clamp(-127.0, 127.0)
                        ).to(torch.int8)
    got_codes, got_scale = q.quantize_rows(x)
    assert torch.isinf(torch.tensor(1.0) / scale[1]).item() or dtype == \
        torch.float32
    assert torch.equal(got_codes, codes)
    assert torch.equal(got_scale.float(), scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_q2_formula_is_dequantize(dtype, bias):
    """Q2's per-element formula, T(T(T(T(f32(acc)) * sx) * sw) + b), equals
    ``dequantize`` bit for bit, on int32 sums up to fc2's 127^2 x 8192;
    above 2^24 the sums go to bf16 through float32, which differs from
    rounding the integer once."""
    gen = torch.Generator().manual_seed(1)
    bound = 127 * 127 * 8192
    acc = torch.randint(-bound, bound + 1, (40, 96), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    acc[0, :4] = torch.tensor([2 ** 24 + 1, 2 ** 25 + 3, -(2 ** 26) - 5,
                               (2 ** 24 + 2 ** 16 + 1)], dtype=torch.int32)
    sx = (torch.rand(40, 1, generator=gen) * 1e-2).to(dtype)
    sw = (torch.rand(96, 1, generator=gen) * 1e-3).to(dtype)
    b = torch.randn(96, generator=gen).to(dtype) if bias else None
    y = _round(acc.float(), dtype)
    y = _round(y * sx.float(), dtype)
    y = _round(y * sw.float().reshape(1, -1), dtype)
    if bias:
        y = _round(y + b.float(), dtype)
    assert torch.equal(q.dequantize(acc, sx, sw, b).float(), y)
    if dtype == torch.bfloat16:
        # 2^24 + 2^16 + 1 lies just above the midpoint of the bf16 values
        # 2^24 and 2^24 + 2^17; through float32 it lands on the midpoint
        # and rounds to even, down
        assert _round(acc[0, 3:4].float(), dtype).item() == 2.0 ** 24


def test_wrapper_checks_before_a_launch():
    """What ``int8_linear``'s kernel path accepts and refuses, checked on
    CPU and meta tensors (the checks read only dtypes, shapes, devices and
    autograd): bigG's served shapes pass; a third dtype, mixed dtypes,
    mismatched widths, an empty contraction or output, mixed devices and a
    call that needs a gradient are refused, and nothing launches."""
    bf = torch.bfloat16
    before = dict(fa.launch_counts)
    x = torch.zeros(2, 8224, 1664, dtype=bf)
    for n in (1664, 8192, 1280):
        q._check_linear(x, torch.zeros(n, 1664, dtype=bf),
                        torch.zeros(n, dtype=bf))
    q._check_linear(torch.zeros(5140, 8192), torch.zeros(1664, 8192), None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        q._check_linear(torch.zeros(4, 8, dtype=torch.float16),
                        torch.zeros(8, 8, dtype=torch.float16), None)
    with pytest.raises(TypeError, match="differ"):
        q._check_linear(torch.zeros(4, 8, dtype=bf), torch.zeros(8, 8), None)
    with pytest.raises(TypeError, match="differ"):
        q._check_linear(torch.zeros(4, 8), torch.zeros(8, 8),
                        torch.zeros(8, dtype=bf))
    for w, b in ((torch.zeros(8, 9), None), (torch.zeros(8, 8),
                                             torch.zeros(7)),
                 (torch.zeros(0, 8), None), (torch.zeros(8, 8, 1), None)):
        with pytest.raises(ValueError, match="product"):
            q._check_linear(torch.zeros(4, 8), w, b)
    with pytest.raises(ValueError, match="product"):
        q._check_linear(torch.zeros(4, 0), torch.zeros(8, 0), None)
    with pytest.raises(ValueError, match="different devices"):
        q._check_linear(torch.zeros(4, 8), torch.zeros(8, 8, device="meta"),
                        None)
    w = torch.zeros(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        q._check_linear(torch.zeros(4, 8), w, None)
    with torch.no_grad():
        q._check_linear(torch.zeros(4, 8), w, None)
    assert fa.launch_counts == before


def test_routes_the_wrapper_picks():
    """Q1 reads 16-byte vectors from contiguous rows of whole vectors
    (bigG's widths; float32's k = 4 mod 8) and takes its scalar route on a
    width off the vector, a misaligned or strided view; Q2 writes vectors
    at whole-vector widths with a contiguous aligned bias or none."""
    bf = torch.bfloat16
    assert q._vector_rows(torch.zeros(16448, 1664, dtype=bf))
    assert q._vector_rows(torch.zeros(5140, 8192, dtype=bf))
    assert q._vector_rows(torch.zeros(3, 1668))
    assert q._vector_rows(torch.zeros(1, 1664, dtype=bf)[:, :1656])
    assert not q._vector_rows(torch.zeros(3, 1663, dtype=bf))
    assert not q._vector_rows(torch.zeros(3, 1668, dtype=bf))
    assert not q._vector_rows(torch.zeros(3, 1672, dtype=bf)[:, 1:1665])
    assert not q._vector_rows(torch.zeros(3, 1668, dtype=bf)[:, :1664])
    assert not q._vector_rows(torch.zeros(1664, 3, dtype=bf).t())
    assert q._vector_bias(None, 1664, 2) and q._vector_bias(None, 51 * 4, 4)
    assert q._vector_bias(torch.zeros(1280, dtype=bf), 1280, 2)
    assert not q._vector_bias(None, 51, 2)
    assert not q._vector_bias(torch.zeros(2, 1280, dtype=bf)[:, 0], 8, 2)
    assert not q._vector_bias(torch.zeros(1281, dtype=bf)[1:], 1280, 2)
    assert [q._padded(k) for k in (1, 8, 51, 1663, 1664)] == [8, 8, 56, 1664,
                                                               1664]


def test_launch_counters_have_the_quantize_kernels():
    """Q1 and Q2 count in the port's launch registry, where a graph's
    replays add what its capture recorded, and reset with it."""
    assert {"int8_quantize", "int8_dequantize"} <= set(fa.launch_counts)
    before = dict(fa.launch_counts)
    fa.add_launches({"int8_quantize": 2 * 289, "int8_dequantize": 289})
    assert fa.launch_counts == {
        **before, "int8_quantize": before["int8_quantize"] + 578,
        "int8_dequantize": before["int8_dequantize"] + 289}
    fa.reset_launch_counts()
    assert fa.launch_counts == dict.fromkeys(before, 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_per_tensor_fault_still_applies(dtype, monkeypatch):
    """The benchmark's ``int8-per-tensor`` fault patches ``layers.
    int8_linear`` and quantizes the whole activation as one row with
    ``quantize_rows``: a ``Linear(int8)`` then runs it, with one scale for
    all tokens, and reads apart from the per-token product."""
    torch.manual_seed(0)
    lin = Linear(64, 24, dtype=dtype, device="cpu")
    q.quantize_linears_int8(lin)
    x = _spread((3, 10, 64), 5, dtype)
    with torch.no_grad():
        per_token = lin(x)
    faults.int8_per_tensor(monkeypatch.setattr)
    assert layers.int8_linear is not q.int8_linear
    codes, scale = q.quantize_rows(x.reshape(1, -1))
    assert codes.shape == (1, 3 * 10 * 64) and scale.shape == (1, 1)
    with torch.no_grad():
        got = lin(x)
    w = lin.weight.to(dtype)
    qw, sw = q.quantize_rows(w)
    want = q.dequantize(q.int8_matmul(codes.reshape(-1, 64), qw),
                        scale.expand(30, 1), sw,
                        lin.bias.to(dtype)).reshape(3, 10, 24)
    assert torch.equal(got, want)
    assert not torch.equal(got, per_token)
