"""The port's CUDA flash-attention kernel (``v2ap_torch/csrc/flash_fwd.cu``)
on the card, against its plain PyTorch version on the same inputs.

Every test here needs an NVIDIA card and nvcc and skips without them. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX for the
rest of the suite.)

Tolerances, against the plain version computed in float32 from the same
inputs: float32 1e-5 max abs (summation order only); bfloat16 1e-2 max abs
(the output's rounding, half an ulp at |o| < 4).
"""

import numpy as np
import pytest
import torch

from v2ap_torch.ops import flash_attention as fa

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _inputs(rng, b, h, nq, nk, d, mask_kind, dtype, device):
    """(b, h, n, d) q/k/v as head views of packed (b, n, h*d) buffers (the
    layout the transformer hands K1), and a (b, nk) mask."""
    def packed(n):
        a = rng.normal(size=(b, n, h * d)).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    q, k, v = packed(nq), packed(nk), packed(nk)
    mask = None
    if mask_kind == "ragged":             # the serving bucket's valid tail
        mask = torch.arange(nk)[None].repeat(b, 1) < torch.tensor(
            [[nk - 18], [nk - 40]])[:b]
    elif mask_kind == "ones":
        mask = torch.ones(b, nk, dtype=torch.bool)
    elif mask_kind == "all_masked":       # batch row 1 attends to nothing
        mask = torch.ones(b, nk, dtype=torch.bool)
        mask[1] = False
    if mask is not None:
        mask = mask.to(device)
    return q, k, v, mask


CASES = [
    # (b, h, nq, nk, d, softclamp, mask, scale)
    pytest.param((2, 16, 800, 800, 64, 50.0, "ragged", None), id="k1_800"),
    pytest.param((2, 8, 800, 800, 64, 50.0, "ragged", None), id="k1_roll_800"),
    pytest.param((2, 16, 800, 1, 64, 50.0, "ones", None), id="k1_cross_nk1"),
    pytest.param((2, 8, 130, 130, 64, 50.0, "all_masked", None),
                 id="k1_fully_masked_row"),
    pytest.param((4, 16, 257, 257, 104, None, "none", 104 ** -0.5),
                 id="k2_bigg_d104"),
    pytest.param((2, 2, 63, 65, 104, 50.0, "ragged", None), id="edges_d104"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case, dtype):
    """Both entry points (K1 on packed views, K2 on (b, h, n, d) views of
    the same buffers) against the plain version, and each launch counted
    once."""
    b, h, nq, nk, d, softclamp, mask_kind, scale = case
    q, k, v, mask = _inputs(np.random.default_rng(0), b, h, nq, nk, d,
                            mask_kind, dtype, cuda)
    heads = [fa._heads_view(t, h, d) for t in (q, k, v)]
    ref = fa.attention_reference(*(t.float() for t in heads), mask,
                                 softclamp=softclamp, scale=scale)
    before = dict(fa.launch_counts)
    out4d = fa.flash_attention(*heads, mask, softclamp=softclamp, scale=scale)
    packed = fa.flash_attention_packed(q, k, v, mask, heads=h, dim_head=d,
                                       softclamp=softclamp, scale=scale)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention"] == \
        before["flash_attention"] + 1
    assert fa.launch_counts["flash_attention_packed"] == \
        before["flash_attention_packed"] + 1
    assert out4d.dtype == packed.dtype == dtype
    assert torch.isfinite(packed).all()
    assert (out4d.float() - ref).abs().max().item() <= TOL[dtype]
    assert (packed.float() - ref.transpose(1, 2).flatten(2)
            ).abs().max().item() <= TOL[dtype]


def test_kernel_matches_plain_on_strided_fused_qkv(cuda):
    """q/k/v as the three chunks of one fused (b, n, 3*h*d) projection: row
    strides of 3*h*d, as the transformer's self-attention passes them."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(size=(2, 200, 3 * 4 * 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    mask = (torch.arange(200, device=cuda) < 150)[None].repeat(2, 1)
    out = fa.flash_attention_packed(q, k, v, mask, heads=4, dim_head=64,
                                    softclamp=50.0)
    ref = fa.flash_attention_packed(q.float().cpu(), k.float().cpu(),
                                    v.float().cpu(), mask.cpu(), heads=4,
                                    dim_head=64, softclamp=50.0)
    torch.cuda.synchronize()
    assert (out.float().cpu() - ref).abs().max().item() <= TOL[torch.bfloat16]


def test_kernel_refuses_what_it_was_not_built_for(cuda):
    """On a CUDA tensor the wrappers launch the kernel or raise; they never
    take the plain version."""
    x = torch.zeros(1, 2, 16, 32, device=cuda)           # head dim 32
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(x, x, x)
    h = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(h, h, h)
    t = torch.zeros(1, 2, 64, 16, device=cuda).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_attention(t, t, t)
