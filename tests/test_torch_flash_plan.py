"""The launch plans around the port's kernels, on the CPU: the forward's
(``v2ap_torch.ops.flash_attention.launch_plan``) and the backward's
(``bwd_launch_plan``).

The tensor-core kernels (``v2ap_torch/csrc/flash_fwd_sm90.cu`` and
``flash_bwd_sm90.cu``) run only on the card, but what surrounds them is
Python that runs here: the dispatch by dtype (bf16 on the tensor cores, f32
on the CUDA cores), the head dim padded to whole 64-column TMA boxes, the
strides the tensor maps get, and the 16-byte (TMA) and 4-byte (bf16 pair
stores) alignment checks that raise instead of copying. These tests build
views at every caller's real widths and strides on CPU tensors (the plans
read only shapes, strides and addresses) and hold the plans to them.
"""

import ctypes
import re

import pytest
import torch

from v2ap_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32


def heads(t, h, d):
    return fa._heads_view(t, h, d)


def plan_of(q, k, v):
    """The plan ``_launch`` computes for these views and a fresh output."""
    return fa.launch_plan(q, k, v, fa._new_like_heads(q, None))


@pytest.mark.parametrize("d,padded", [(16, 64), (32, 64), (64, 64),
                                      (104, 128)])
def test_bf16_runs_on_the_tensor_cores_at_every_built_head_dim(d, padded):
    """bf16 at each built head dim takes the wgmma route; the head dim is
    padded to whole 64-column boxes (d = 104 spans two, its last 24 columns
    zero-filled by TMA)."""
    assert d in fa._HEAD_DIMS
    q, k, v = (torch.zeros(2, 3, 70, d, dtype=BF16) for _ in range(3))
    plan = plan_of(q, k, v)
    assert (plan.route, plan.head_dim, plan.padded_dim, plan.box_cols) == \
        ("wgmma", d, padded, 64)
    assert plan.padded_dim % plan.box_cols == 0
    assert plan.box_cols * q.element_size() == 128      # the swizzle span


@pytest.mark.parametrize("d", [16, 32, 64, 104])
def test_f32_stays_on_the_cuda_cores(d):
    """f32 keeps the CUDA-core kernel in full f32: no padding, no TMA, and
    no alignment demand (a view 4 bytes past a granule is taken)."""
    buf = torch.zeros(2, 70, 3 * d + 1)
    q, k, v = (heads(buf[..., 1 + i * d:1 + (i + 1) * d], 1, d)
               for i in range(3))
    plan = plan_of(q, k, v)
    assert (plan.route, plan.padded_dim, plan.box_cols) == ("cuda_core", d, 0)
    assert plan.strides[:3] == q.stride()[:3]


def _fused_qkv(b, n, h, d):
    """The three chunks of a fused (b, n, 3*h*d) projection as head views,
    as ``Attention`` passes them for self-attention."""
    qkv = torch.zeros(b, n, 3 * h * d, dtype=BF16)
    return [heads(t, h, d) for t in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("b,n,h", [(2, 800, 16), (2, 800, 8), (8, 782, 16)],
                         ids=["serving_self", "roll_self", "train_self"])
def test_fused_qkv_chunks(b, n, h):
    """K1 / K3: k and v start 2048 (1024 for 8 heads) bytes into each row,
    rows 6144 (3072) bytes apart, heads 128 bytes apart."""
    q, k, v = _fused_qkv(b, n, h, 64)
    assert (k.data_ptr() - q.data_ptr()) == h * 64 * 2
    plan = plan_of(q, k, v)
    row = 3 * h * 64
    assert plan.route == "wgmma"
    assert plan.strides[:9] == (n * row, 64, row) * 3
    assert plan.strides[9:] == (n * h * 64, 64, h * 64)  # the fresh output
    for st in plan.strides[:9]:
        assert st * 2 % 16 == 0


def test_clip_d104_head_views():
    """K2: ViT-bigG's separate q/k/v projections (64, 257, 1664) split into
    16 heads of 104: heads 208 bytes apart, rows 3328."""
    q, k, v = (heads(torch.zeros(64, 257, 1664, dtype=BF16), 16, 104)
               for _ in range(3))
    plan = plan_of(q, k, v)
    assert (plan.route, plan.padded_dim) == ("wgmma", 128)
    assert plan.strides[:3] == (257 * 1664, 104, 1664)
    assert 104 * 2 == 208 and 208 % 16 == 0


def test_probe_packed_views():
    """P1: the probe's rotated q and k (fresh (b, n, h*d) tensors) and v, a
    chunk of the fused (24, 768, 3072) qkv."""
    b, n, h, d = 24, 768, 16, 64
    qkv = torch.zeros(b, n, 3 * h * d, dtype=BF16)
    v = heads(qkv.chunk(3, dim=-1)[2], h, d)
    q = heads(torch.zeros(b, n, h * d, dtype=BF16), h, d)
    plan = plan_of(q, q, v)
    assert plan.strides == ((n * h * d, d, h * d) * 2 + (n * 3 * h * d, d,
                                                         3 * h * d)
                            + (n * h * d, d, h * d))


def test_cross_attention_nk1_and_prompt_context():
    """K1's cross-attention: an empty prompt's single key and the prompt's
    64 tokens, from separate to_k / to_v projections."""
    q = heads(torch.zeros(2, 800, 1024, dtype=BF16), 16, 64)
    k1 = heads(torch.zeros(2, 1, 1024, dtype=BF16), 16, 64)
    assert plan_of(q, k1, k1).strides[3:6] == (1024, 64, 1024)
    k64 = heads(torch.zeros(2, 64, 1024, dtype=BF16), 16, 64)
    assert plan_of(q, k64, k64).strides[3:6] == (64 * 1024, 64, 1024)


def test_size1_dim_with_a_stride_tma_refuses():
    """A dim of size 1 is never stepped: a stride TMA would refuse there (0,
    or not a 16-byte multiple) becomes one 16-byte granule instead of
    raising; the same stride on a longer dim raises."""
    buf = torch.zeros(2 * 4 * 64 * 3, dtype=BF16)
    one = buf.as_strided((2, 4, 1, 64), (4 * 64 * 3, 64, 3, 1))
    assert fa._tma_strides(one, "k") == (4 * 64 * 3, 64, 8)
    zero = buf.as_strided((2, 4, 1, 64), (4 * 64 * 3, 64, 0, 1))
    assert fa._tma_strides(zero, "k") == (4 * 64 * 3, 64, 8)
    with pytest.raises(ValueError, match="16-byte multiples"):
        fa._tma_strides(buf.as_strided((2, 4, 2, 64), (4 * 64 * 3, 64, 3, 1)),
                        "k")


@pytest.mark.parametrize("what", ["base", "row_stride", "head_stride"])
def test_misaligned_bf16_view_raises(what):
    """A bf16 view TMA cannot load raises ValueError; nothing copies it or
    falls back to the CUDA-core kernel."""
    if what == "base":        # starts 2 bytes past a granule
        buf = torch.zeros(2, 100, 4 * 64 + 1, dtype=BF16)
        t = heads(buf[..., 1:1 + 4 * 64], 4, 64)
        match = "16-byte aligned base"
    elif what == "row_stride":  # rows 2056 bytes apart
        buf = torch.zeros(2, 100, 1028, dtype=BF16)
        t = heads(buf[..., :1024], 16, 64)
        match = "16-byte multiples"
    else:                       # heads 2 * 68 bytes apart, 136 = 8.5 granules
        buf = torch.zeros(2, 100, 4 * 68, dtype=BF16)
        t = buf.unflatten(-1, (4, 68))[..., :64].transpose(1, 2)
        match = "16-byte multiples"
    ok = heads(torch.zeros(2, 100, 4 * 64, dtype=BF16), 4, 64)
    with pytest.raises(ValueError, match=match):
        plan_of(t, ok, ok)
    with pytest.raises(ValueError, match=match):
        plan_of(ok, t, ok)
    with pytest.raises(ValueError, match=match):
        plan_of(ok, ok, t)


def test_misaligned_bf16_output_raises():
    """The output is stored as bf16 pairs: an odd row stride raises."""
    q = heads(torch.zeros(2, 100, 4 * 64, dtype=BF16), 4, 64)
    out = torch.zeros(2, 100, 4 * 64 + 1, dtype=BF16)[..., :256]
    with pytest.raises(ValueError, match="4-byte alignment"):
        fa.launch_plan(q, q, q, heads(out, 4, 64))


def test_the_tensor_core_source_is_built():
    """The library's sources, and so its hash and ``chip_smoke.py``'s build,
    include both tensor-core kernels (and the fused norms and the int8
    quantize and dequantize, built into the same library); the headers they
    share are part of the hash, so an edit to one rebuilds the library."""
    names = [src.name for src in fa._SOURCES]
    assert names == ["flash_fwd_sm90.cu", "flash_bwd_sm90.cu", "flash_fwd.cu",
                     "flash_bwd.cu", "norms.cu", "quantize.cu"]
    assert [h.name for h in fa._HEADERS] == ["sm90_common.cuh", "vec16.cuh"]
    assert all(path.exists() for path in fa._SOURCES + fa._HEADERS)
    header = fa._HEADERS[0].read_text()
    assert "wgmma.mma_async" in header and "cp.async.bulk.tensor" in header
    included = set()
    for src in fa._SOURCES:
        included |= set(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert included == {"sm90_common.cuh", "vec16.cuh"}
    for src in fa._SOURCES[:2]:     # both tensor-core kernels use wgmma + TMA
        text = src.read_text()
        assert '#include "sm90_common.cuh"' in text
        assert "wgmma_ss_n64(" in text and "tma_load(" in text
    bwd = fa._SOURCES[1].read_text()
    assert "wgmma_rs(" in bwd           # dQ, dK, dV with register A operands


@pytest.mark.parametrize("which", [0, 1], ids=["sm90_common", "vec16"])
def test_the_header_is_part_of_the_library_hash(tmp_path, monkeypatch,
                                                which):
    """An edit to a shared header changes the digest that names the
    library, as an edit to a source does."""
    before = fa._library_digest()
    headers = list(fa._HEADERS)
    copy = tmp_path / headers[which].name
    copy.write_bytes(headers[which].read_bytes() + b"// edited\n")
    headers[which] = copy
    monkeypatch.setattr(fa, "_HEADERS", tuple(headers))
    assert fa._library_digest() != before


# --------------------------------------------------------------- backward

def grads_of(which, q, k, v, packed_heads=None):
    """The gradient buffers ``_FlashAttentionFn.backward`` allocates, as the
    (b, h, n, d) views it hands the kernels: views of packed (b, n, h*d)
    buffers under ``flash_attention_packed`` (``packed_heads`` given), else
    of (b, n, h, d) buffers."""
    names = ("dq",) if which == "dq" else ("dk", "dv")
    ts = (q,) if which == "dq" else (k, v)
    if packed_heads is None:
        return {n: fa._new_like_heads(t, None) for n, t in zip(names, ts)}
    return {n: heads(fa._new_like_heads(t.transpose(1, 2).flatten(2),
                                        packed_heads), packed_heads,
                     t.shape[-1]) for n, t in zip(names, ts)}


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("d,padded", [(16, 64), (32, 64), (64, 64),
                                      (104, 128)])
def test_backward_dispatch_by_dtype_at_every_built_head_dim(d, padded, which):
    """K4 and K5: bf16 at each built head dim takes the wgmma route
    (flash_bwd_sm90.cu), the head dim padded to whole 64-column boxes as the
    forward's; f32 stays on the CUDA cores in full f32, unpadded."""
    assert d in fa._HEAD_DIMS
    for dtype in (BF16, F32):
        q, k, v, dout = (torch.zeros(2, 3, 70, d, dtype=dtype)
                         for _ in range(4))
        grads = grads_of(which, q, k, v)
        plan = fa.bwd_launch_plan(q, k, v, dout, grads)
        if dtype == BF16:
            assert (plan.route, plan.head_dim, plan.padded_dim,
                    plan.box_cols) == ("wgmma", d, padded, 64)
        else:
            assert (plan.route, plan.head_dim, plan.padded_dim,
                    plan.box_cols) == ("cuda_core", d, d, 0)
        assert len(plan.strides) == 18     # q, k, v, dout, two gradients
        g = [st for t in grads.values() for st in t.stride()[:3]]
        assert list(plan.strides[12:]) == g + [0] * (6 - len(g))


def _train_views(b, n, h, nk, kind):
    """The views a training step hands K4 and K5 (d = 64): q/k/v as the
    chunks of a fused qkv projection (self-attention) or q with the chunks
    of a (b, nk, 2*h*d) k/v projection of the prompt context
    (cross-attention); dout as the head views of the packed (b, n, h*d)
    gradient of the output."""
    d, hd = 64, h * 64
    if kind == "self":
        q, k, v = (heads(t, h, d) for t in
                   torch.zeros(b, n, 3 * hd, dtype=BF16).chunk(3, dim=-1))
    else:
        q = heads(torch.zeros(b, n, hd, dtype=BF16), h, d)
        k, v = (heads(t, h, d) for t in
                torch.zeros(b, nk, 2 * hd, dtype=BF16).chunk(2, dim=-1))
    dout = heads(torch.zeros(b, n, hd, dtype=BF16), h, d)
    return q, k, v, dout


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("b,n,h,nk,kind", [
    (8, 782, 16, 782, "self"), (8, 782, 8, 782, "self"),
    (8, 782, 16, 16, "cross")], ids=["train_self", "train_roll_self",
                                     "train_cross_nk16"])
def test_backward_at_the_training_callers_strides(b, n, h, nk, kind, which):
    """K4 / K5 at the training step's real views: fused-qkv chunks at (8,
    782, 16x64) and the roll stream's (8, 782, 8x64), the cross-attention's
    k/v chunks at nk = 16; the gradients are the packed (b, n, h*d) buffers
    of ``_new_like_heads``. Every TMA stride is a 16-byte multiple, every
    gradient stride even."""
    q, k, v, dout = _train_views(b, n, h, nk, kind)
    hd = h * 64
    grads = grads_of(which, q, k, v, packed_heads=h)
    plan = fa.bwd_launch_plan(q, k, v, dout, grads)
    assert plan.route == "wgmma" and plan.padded_dim == 64
    row = 3 * hd if kind == "self" else hd
    kv_row = 3 * hd if kind == "self" else 2 * hd
    assert plan.strides[:3] == (n * row, 64, row)
    assert plan.strides[3:9] == (nk * kv_row, 64, kv_row) * 2
    assert plan.strides[9:12] == (n * hd, 64, hd)             # dout
    n_g = n if which == "dq" else nk
    expect = (n_g * hd, 64, hd) * (1 if which == "dq" else 2)
    assert plan.strides[12:] == expect + (0,) * (6 - len(expect))
    for st in plan.strides[:12]:
        assert st * 2 % 16 == 0
    assert all(st % 2 == 0 for st in plan.strides[12:])


@pytest.mark.parametrize("what", ["dout_base", "dout_row_stride",
                                  "grad_base", "grad_row_stride"])
def test_misaligned_backward_views_raise(what):
    """A bf16 dout that TMA cannot load, or a gradient view that bf16 pair
    stores cannot write, raises ValueError; the f32 route takes the same
    views (the CUDA-core kernels have no alignment demand)."""
    for dtype in (BF16, F32):
        ok = lambda: heads(torch.zeros(2, 100, 4 * 64, dtype=dtype), 4, 64)
        q, k, v, dout = ok(), ok(), ok(), ok()
        grads = {"dq": ok()}
        if what == "dout_base":     # 2 bytes past a 16-byte granule
            dout = heads(torch.zeros(2, 100, 4 * 64 + 1, dtype=dtype)[..., 1:],
                         4, 64)
            match = "16-byte aligned base"
        elif what == "dout_row_stride":   # rows 2056 bytes apart
            dout = heads(torch.zeros(2, 100, 1028, dtype=dtype)[..., :256],
                         4, 64)
            match = "16-byte multiples"
        elif what == "grad_base":   # 2 bytes past a 4-byte word
            grads = {"dk": heads(torch.zeros(2, 100, 4 * 64 + 1,
                                             dtype=dtype)[..., 1:], 4, 64),
                     "dv": ok()}
            match = "4-byte alignment"
        else:                       # an odd row stride
            grads = {"dk": ok(), "dv": heads(torch.zeros(
                2, 100, 4 * 64 + 1, dtype=dtype)[..., :256], 4, 64)}
            match = "4-byte alignment"
        if dtype == BF16:
            with pytest.raises(ValueError, match=match):
                fa.bwd_launch_plan(q, k, v, dout, grads)
        else:
            assert fa.bwd_launch_plan(q, k, v, dout, grads).route == \
                "cuda_core"


def test_backward_copies_an_output_gradient_tma_cannot_load(monkeypatch):
    """Autograd may hand ``_FlashAttentionFn.backward`` an output gradient
    with zero strides (an expanded tensor); TMA takes no such view, so the
    backward copies it (as it copies a strided last dim) before K4 and K5
    see it, and the gradients equal those of the same gradient made
    contiguous."""
    b, n, h, d = 2, 24, 2, 16
    g = torch.Generator().manual_seed(0)
    base = torch.randn(b, n, 3 * h * d, generator=g).to(BF16)
    w = torch.randn(1, n, h * d, generator=g).to(BF16)
    expanded = w.expand(b, n, h * d)
    assert not fa._tma_loadable(heads(expanded, h, d))
    assert fa._tma_loadable(heads(expanded.contiguous(), h, d))
    seen = []
    for name in ("attention_bwd_dq", "attention_bwd_dkv"):
        def spy(*args, _fn=getattr(fa, name), **kw):
            seen.append(args[6])                        # dout
            return _fn(*args, **kw)
        monkeypatch.setattr(fa, name, spy)
    grads = []
    threads = torch.get_num_threads()
    # one thread: the plain path's sums then run in one order whatever the
    # load, so the two backwards may be compared bit for bit
    torch.set_num_threads(1)
    try:
        for weight in (expanded, expanded.contiguous()):
            x = base.clone().requires_grad_(True)
            out = fa.flash_attention_packed(*x.chunk(3, dim=-1), heads=h,
                                            dim_head=d, softclamp=50.0)
            out.backward(weight)
            grads.append(x.grad)
    finally:
        torch.set_num_threads(threads)
    assert len(seen) == 4 and all(fa._tma_loadable(t) for t in seen)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("name", sorted(fa._c_argtypes()))
def test_bindings_match_the_c_entry_points(name):
    """The ctypes argument types of each entry point follow its C parameter
    list in the sources, one for one: ctypes does not check them, and no
    card here would show a call that passes one too many."""
    text = "".join(path.read_text() for path in fa._SOURCES)
    found = re.findall(rf"\bint {name}\(([^)]*)\)\s*{{", text)
    assert len(found) == 1, found
    scalars = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "float": ctypes.c_float}
    want = []
    for param in found[0].split(","):
        ctype = " ".join(param.split()[:-1]).replace("const ", "")
        if ctype == "long long*":
            want.append(ctypes.POINTER(ctypes.c_longlong))
        elif ctype.endswith("*"):
            want.append(ctypes.c_void_p)
        else:
            want.append(scalars[ctype])
    assert fa._c_argtypes()[name] == want
