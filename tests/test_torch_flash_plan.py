"""The launch plan around the port's forward kernels
(``v2ap_torch.ops.flash_attention.launch_plan``), on the CPU.

The tensor-core kernel (``v2ap_torch/csrc/flash_fwd_sm90.cu``) runs only on
the card, but what surrounds it is Python that runs here: the dispatch by
dtype (bf16 on the tensor cores, f32 on the CUDA cores), the head dim padded
to whole 64-column TMA boxes, the strides its tensor maps get, and the
16-byte alignment check that raises instead of copying. These tests build
views at every caller's real widths and strides on CPU tensors (the plan
reads only shapes, strides and addresses) and hold the plan to them.
"""

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
    include the tensor-core kernel."""
    names = [src.name for src in fa._SOURCES]
    assert names == ["flash_fwd_sm90.cu", "flash_fwd.cu", "flash_bwd.cu"]
    assert all(src.exists() for src in fa._SOURCES)
    text = fa._SOURCES[0].read_text()
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text
