"""The port's CUDA flash-attention kernels (the forward for K1, K2, K3 and
the probe's P1: ``v2ap_torch/csrc/flash_fwd_sm90.cu`` on the tensor cores
for bf16, ``flash_fwd.cu`` on the CUDA cores for f32; the backward K4 and
K5: ``flash_bwd_sm90.cu`` for bf16, ``flash_bwd.cu`` for f32) and its fused
norms (N1 ``rms_norm``, N2 ``gated_residual``: ``norms.cu``) and the int8
``Linear``'s quantize and dequantize (Q1, Q2: ``quantize.cu``) on the card,
against their plain PyTorch versions on the same inputs.

Every test here needs an NVIDIA card and nvcc and skips without them. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX for the
rest of the suite.) The last tests check the training slice on the card:
remat against no remat in bf16 and the checkpoint round trip.

Tolerances, against the plain version computed in float32 from the same
inputs: float32 1e-5 max abs (summation order only); bfloat16 1e-2 max abs
(the output's rounding, half an ulp at |o| < 4). The backward kernels get
the same lse, D and dO as their plain version, so only the gradients'
rounding and the summation order differ: float32 1e-4, bfloat16 2^-7, each
times max(1, max|ref|); lse rtol 1e-5. P1 is held as ``chip_smoke.py``
holds it: float32 1e-4, bfloat16 2^-7, each times max(1, max|ref|). The
tensor-core cases of the forward are held as ``chip_smoke.py`` holds them:
2^-7 times max(1, max|ref|), lse 1e-3; those of the backward at the training
shapes likewise, 2^-7 times max(1, max|ref|). The fused norms are held
against their plain version on the card in the same dtype: N1 within one
bf16 step (only the order of the sum of squares differs; f32 1e-5 times
max(1, |ref|)), N2 bit-equal (the same two roundings). Q1 and Q2 are
bit-equal to the plain chain (the same roundings, step by step).
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
    # CLIP ViT-L/14-336: 577 tokens (9 x 64 + 1, the last row tile ragged)
    pytest.param((4, 16, 577, 577, 64, None, "none", 64 ** -0.5),
                 id="k2_clip_l_577_d64"),
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
    x = torch.zeros(1, 2, 16, 48, device=cuda)           # head dim 48
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(x, x, x)
    h = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(h, h, h)
    t = torch.zeros(1, 2, 64, 16, device=cuda).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_attention(t, t, t)


BWD_CASES = [
    # (b, h, nq, nk, d, softclamp, mask)
    pytest.param((2, 16, 200, 200, 64, 50.0, "ragged"), id="self_d64"),
    pytest.param((2, 8, 130, 130, 64, 50.0, "all_masked"),
                 id="fully_masked_element"),
    pytest.param((2, 16, 200, 16, 64, 50.0, "ragged"), id="cross_nk16"),
    pytest.param((2, 2, 63, 65, 104, 50.0, "ragged"), id="edges_d104"),
    pytest.param((2, 2, 70, 33, 32, 50.0, "ragged"), id="edges_d32"),
    pytest.param((2, 2, 70, 33, 16, None, "ones"), id="edges_d16"),
]


def _check(got, ref, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    bound = tol * max(1.0, ref.abs().max().item())
    assert (got.float() - ref).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_lse_and_backward_kernels_match_plain(cuda, case, dtype):
    """K3 (out, lse), K4 (dq) and K5 (dk, dv) on (b, h, n, d) views of
    packed buffers against the plain versions on the same inputs; each
    launch counted once; a fully masked batch element gets exactly zero
    gradient."""
    b, h, nq, nk, d, softclamp, mask_kind = case
    rng = np.random.default_rng(2)
    q, k, v, mask = _inputs(rng, b, h, nq, nk, d, mask_kind, dtype, cuda)
    q, k, v = (fa._heads_view(t, h, d) for t in (q, k, v))
    dout = torch.from_numpy(rng.normal(size=(b, h, nq, d)).astype(
        np.float32)).to(cuda, dtype)
    before = dict(fa.launch_counts)
    out, lse = fa.attention_fwd_lse(q, k, v, mask, softclamp=softclamp)
    ref_out, ref_lse = fa.attention_fwd_lse_reference(
        q.float(), k.float(), v.float(), mask, softclamp=softclamp)
    _check(out, ref_out, TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    delta = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, mask, lse, delta, dout)
    dq = fa.attention_bwd_dq(*args, softclamp=softclamp)
    dk, dv = fa.attention_bwd_dkv(*args, softclamp=softclamp)
    ref = fa.attention_bwd_reference(q.float(), k.float(), v.float(), mask,
                                     lse, delta, dout.float(),
                                     softclamp=softclamp)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}[dtype]
    for got, r in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == r.shape
        _check(got, r, tol)
        if mask_kind == "all_masked":
            assert not got[1].any()
    for name in ("flash_attention_lse", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert fa.launch_counts[name] == before[name] + 1


def test_autograd_path_launches_k3_k4_k5(cuda):
    """Under autograd the packed entry point launches K3 (not K1) and its
    backward K4 and K5; the gradients equal the CPU autograd path's (the
    plain versions) in f32."""
    rng = np.random.default_rng(3)
    b, n, h, d = 2, 150, 4, 64
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    mask = torch.from_numpy(np.arange(n)[None].repeat(b, 0) < [[150], [99]])
    w = torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        x = torch.from_numpy(qkv).to(dev).requires_grad_(True)
        before = dict(fa.launch_counts)
        out = fa.flash_attention_packed(*x.chunk(3, dim=-1), mask.to(dev),
                                        heads=h, dim_head=d, softclamp=50.0)
        (out * w.to(dev)).sum().backward()
        grads[dev] = x.grad.cpu()
        launched = {k: fa.launch_counts[k] - before[k] for k in before}
        expect = dict.fromkeys(before, 0)
        if dev == "cuda":
            expect.update(flash_attention_lse=1, flash_attention_bwd_dq=1,
                          flash_attention_bwd_dkv=1)
        assert launched == expect
    torch.cuda.synchronize()
    assert (grads["cuda"] - grads["cpu"]).abs().max().item() <= \
        1e-4 * max(1.0, grads["cpu"].abs().max().item())


BNHD_CASES = [
    # (b, n, h, d, softclamp, mask)
    pytest.param((2, 768, 16, 64, 50.0, "ones"), id="probe_width"),
    pytest.param((2, 130, 8, 64, 50.0, "all_masked"),
                 id="fully_masked_element"),
    pytest.param((2, 100, 4, 64, None, "ragged"), id="no_softclamp_ragged"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BNHD_CASES)
def test_flash_bnhd_matches_plain(cuda, case, dtype):
    """P1 (``flash_bnhd``, the probe's packed-layout kernel) on packed
    tensors against the plain version, its launch counted once under its
    own key and no other kernel's."""
    from v2ap_torch.scripts.probe_flash_bnhd import flash_bnhd

    b, n, h, d, softclamp, mask_kind = case
    q, k, v, mask = _inputs(np.random.default_rng(5), b, h, n, n, d,
                            mask_kind, dtype, cuda)
    ref = fa.attention_reference(
        *(fa._heads_view(t.float(), h, d) for t in (q, k, v)), mask,
        softclamp=softclamp).transpose(1, 2).flatten(2)
    before = dict(fa.launch_counts)
    out = flash_bnhd(q, k, v, mask, softclamp=softclamp, heads=h,
                     dim_head=d)
    torch.cuda.synchronize()
    launched = {k_: fa.launch_counts[k_] - before[k_] for k_ in before}
    assert launched == {**dict.fromkeys(before, 0), "flash_bnhd": 1}
    assert out.shape == q.shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}[dtype]
    assert (out.float() - ref).abs().max().item() <= \
        tol * max(1.0, ref.abs().max().item())


def test_probe_paths_agree_on_the_card(cuda):
    """The probe's two paths at a small width: the old one launches K2's
    entry point, the new one P1, once each; they agree to bf16 rounding."""
    from v2ap_torch.scripts import probe_flash_bnhd as probe

    b, n, h, d = 2, 96, 4, 64
    qkv, mask, rot = probe.probe_inputs(b, n, h, d, cuda)
    old_path, new_path = probe.make_paths(b, n, h, d, rot, mask)
    fa.reset_launch_counts()
    old, new = old_path(qkv), new_path(qkv)
    torch.cuda.synchronize()
    assert fa.launch_counts == {**dict.fromkeys(fa.launch_counts, 0),
                                "flash_attention": 1, "flash_bnhd": 1}
    assert probe.rel_rms(new, old) < 1e-2


def test_trainer_steps_pick_their_kernels(cuda):
    """On the tiny configuration, Trainer.train_step launches K3, K4 and K5
    once per attention (3 self + 1 cross per layer) and no K1, N1 or N2;
    eval_step runs without autograd and so launches K1 and none of K3-K5,
    and N1 and N2 once per norm and gate of its forward."""
    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.training import Trainer

    base = C.tiny_test()
    torch.manual_seed(0)
    model = CFM(base.model, base.conditioning, device=cuda)
    trainer = Trainer(model, C.TrainConfig(learning_rate=1e-3,
                                           warmup_steps=2))
    rng = np.random.default_rng(4)
    b, n, nc = 2, 40, 6
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    batch = {"latents": r(b, n, base.model.num_channels),
             "lens": torch.tensor([n, n - 9]),
             "text_embed": r(b, n, base.model.dim_text),
             "context": r(b, nc, base.model.dim_context),
             "context_mask": torch.arange(nc)[None] < torch.tensor([[nc], [3]])}
    per_step = 4 * base.model.depth
    for step, expect in (
            (trainer.train_step, dict(flash_attention_lse=per_step,
                                      flash_attention_bwd_dq=per_step,
                                      flash_attention_bwd_dkv=per_step)),
            (trainer.eval_step, dict(flash_attention_packed=per_step,
                                     **_norm_launches(base.model, 1)))):
        fa.reset_launch_counts()
        loss = step(batch)[0]
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert fa.launch_counts == {**dict.fromkeys(fa.launch_counts, 0),
                                    **expect}


def _kernel_names(fn) -> list:
    """Names of the CUDA kernels one ``fn()`` launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0]


@pytest.mark.parametrize("dtype,kernel,other", [
    (torch.bfloat16, "flash_fwd_sm90_kernel<64>", "flash_fwd_kernel<"),
    (torch.float32, "flash_fwd_kernel<64>", "flash_fwd_sm90_kernel<")],
    ids=["bf16", "f32"])
def test_forward_dispatch_by_dtype(cuda, dtype, kernel, other):
    """bf16 runs the tensor-core kernel and f32 the CUDA-core one, each
    without the other."""
    q, k, v, mask = _inputs(np.random.default_rng(6), 2, 4, 100, 100, 64,
                            "ragged", dtype, cuda)
    names = _kernel_names(lambda: fa.flash_attention_packed(
        q, k, v, mask, heads=4, dim_head=64, softclamp=50.0))
    assert any(kernel in n for n in names), names
    assert not any(other in n for n in names), names


TC_CASES = [
    # (label, b, n, h, nk, valid keys, softclamp, logit gain)
    pytest.param(("fused_qkv", 2, 800, 16, 800, 782, 50.0, 1.0),
                 id="fused_qkv_chunks_800"),
    pytest.param(("fused_qkv", 2, 782, 16, 782, 782, 50.0, 40.0),
                 id="fused_qkv_logits_std40"),
    pytest.param(("prompt", 2, 800, 16, 64, 11, 50.0, 1.0),
                 id="prompt_nk64_11_valid"),
    pytest.param(("prompt", 2, 800, 16, 1, 1, 50.0, 1.0), id="prompt_nk1"),
]


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_forward_with_lse(cuda, case):
    """K3 in bf16 through the tensor-core kernel on the views the
    transformer passes (the chunks of a fused qkv, or q with to_k / to_v
    chunks of a prompt context whose first ``valid`` keys attend): output
    within 2^-7 max(1, max|ref|) of the plain version, lse within 1e-3;
    then K1 on the packed entry point, the same output."""
    kind, b, n, h, nk, valid, softclamp, gain = case
    g = torch.Generator(device=cuda).manual_seed(7)
    hd = h * 64
    if kind == "fused_qkv":
        qkv = torch.randn(b, n, 3 * hd, generator=g, device=cuda)
        qkv[..., :hd] *= gain
        q, k, v = qkv.to(torch.bfloat16).chunk(3, dim=-1)
    else:
        q = torch.randn(b, n, hd, generator=g, device=cuda).to(torch.bfloat16)
        k, v = torch.randn(b, nk, 2 * hd, generator=g, device=cuda).to(
            torch.bfloat16).chunk(2, dim=-1)
    mask = (torch.arange(nk, device=cuda) < valid)[None].repeat(b, 1)
    qh, kh, vh = (fa._heads_view(t, h, 64) for t in (q, k, v))
    assert fa.launch_plan(qh, kh, vh, fa._new_like_heads(qh, None)).route \
        == "wgmma"
    out, lse = fa.attention_fwd_lse(qh, kh, vh, mask, softclamp=softclamp)
    ref, ref_lse = fa.attention_fwd_lse_reference(
        qh.float(), kh.float(), vh.float(), mask, softclamp=softclamp)
    _check(out, ref, 2.0 ** -7)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    packed = fa.flash_attention_packed(q, k, v, mask, heads=h, dim_head=64,
                                       softclamp=softclamp)
    _check(packed, ref.transpose(1, 2).flatten(2), 2.0 ** -7)


def test_misaligned_bf16_view_raises_on_the_card(cuda):
    """A bf16 view whose base is not 16-byte aligned raises ValueError
    before any launch; the f32 view at the same offset runs on the CUDA
    cores."""
    buf = torch.zeros(2, 100, 4 * 64 + 1, device=cuda)
    before = dict(fa.launch_counts)
    for dtype in (torch.bfloat16, torch.float32):
        t = buf.to(dtype)[..., 1:]
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte aligned base"):
                fa.flash_attention_packed(t, t, t, heads=4, dim_head=64)
            assert fa.launch_counts == before
        else:
            out = fa.flash_attention_packed(t, t, t, heads=4, dim_head=64)
            torch.cuda.synchronize()
            assert torch.isfinite(out).all()


def _bwd_args(q, k, v, mask, dout, softclamp=50.0):
    """(q, k, v, mask, lse, delta, dout) for K4 / K5 from K3's forward on
    the same views, as the train step computes them."""
    out, lse = fa.attention_fwd_lse(q, k, v, mask, softclamp=softclamp)
    delta = (dout.float() * out.float()).sum(-1)
    return q, k, v, mask, lse, delta, dout


@pytest.mark.parametrize("dtype,kernels,others", [
    (torch.bfloat16, ("flash_bwd_dq_sm90_kernel<64>",
                      "flash_bwd_dkv_sm90_kernel<64>"),
     ("flash_bwd_dq_kernel<", "flash_bwd_dkv_kernel<")),
    (torch.float32, ("flash_bwd_dq_kernel<64>", "flash_bwd_dkv_kernel<64>"),
     ("flash_bwd_dq_sm90_kernel<", "flash_bwd_dkv_sm90_kernel<"))],
    ids=["bf16", "f32"])
def test_backward_dispatch_by_dtype(cuda, dtype, kernels, others):
    """K4 and K5 in bf16 run only the tensor-core backward kernels, in f32
    only the CUDA-core ones."""
    rng = np.random.default_rng(8)
    q, k, v, mask = _inputs(rng, 2, 4, 100, 100, 64, "ragged", dtype, cuda)
    q, k, v = (fa._heads_view(t, 4, 64) for t in (q, k, v))
    dout = fa._heads_view(torch.from_numpy(rng.normal(size=(2, 100, 256))
                                           .astype(np.float32)).to(cuda, dtype),
                          4, 64)
    args = _bwd_args(q, k, v, mask, dout)
    names = _kernel_names(lambda: (fa.attention_bwd_dq(*args, softclamp=50.0),
                                   fa.attention_bwd_dkv(*args, softclamp=50.0)))
    for kernel in kernels:
        assert any(kernel in n for n in names), names
    assert not any(o in n for o in others for n in names), names


TC_BWD_CASES = [
    # (label, b, n, h, nk, logit gain)
    pytest.param(("fused_qkv", 8, 782, 16, 782, 1.0), id="train_self_16x64"),
    pytest.param(("fused_qkv", 8, 782, 16, 782, 40.0),
                 id="train_self_logits_std40"),
    pytest.param(("fused_qkv", 8, 782, 8, 782, 1.0), id="train_roll_8x64"),
    pytest.param(("context", 8, 782, 16, 16, 1.0), id="train_cross_nk16"),
]


def _train_views(cuda, kind, b, n, h, nk, gain, seed=9):
    """The training step's bf16 views at d = 64: the chunks of a fused qkv
    (q scaled by ``gain``), or q with the k/v chunks of a prompt context of
    ``nk`` tokens (4 to nk valid); the output gradient's head views; the
    mask."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hd = h * 64
    if kind == "fused_qkv":
        qkv = torch.randn(b, n, 3 * hd, generator=g, device=cuda)
        qkv[..., :hd] *= gain
        q, k, v = qkv.to(torch.bfloat16).chunk(3, dim=-1)
        mask = torch.ones(b, n, dtype=torch.bool, device=cuda)
    else:
        q = torch.randn(b, n, hd, generator=g, device=cuda).to(torch.bfloat16)
        k, v = torch.randn(b, nk, 2 * hd, generator=g, device=cuda).to(
            torch.bfloat16).chunk(2, dim=-1)
        lens = torch.randint(4, nk + 1, (b, 1), generator=g, device=cuda)
        mask = torch.arange(nk, device=cuda)[None] < lens
    dout = torch.randn(b, n, hd, generator=g, device=cuda).to(torch.bfloat16)
    return [fa._heads_view(t, h, 64) for t in (q, k, v)] + [
        mask, fa._heads_view(dout, h, 64)]


@pytest.mark.parametrize("case", TC_BWD_CASES)
def test_tensor_core_backward_at_training_shapes(cuda, case):
    """K4 and K5 in bf16 through the tensor-core kernels on the views the
    train step passes (fused-qkv chunks, the roll stream's 8 heads, the
    cross-attention's context chunks), also with logits of std 40: each
    gradient within 2^-7 max(1, max|ref|) of the plain version on the same
    lse, D and dO."""
    kind, b, n, h, nk, gain = case
    q, k, v, mask, dout = _train_views(cuda, kind, b, n, h, nk, gain)
    args = _bwd_args(q, k, v, mask, dout)
    grads = {"dq": fa._new_like_heads(q, None)}
    assert fa.bwd_launch_plan(q, k, v, dout, grads).route == "wgmma"
    dq = fa.attention_bwd_dq(*args, softclamp=50.0)
    dk, dv = fa.attention_bwd_dkv(*args, softclamp=50.0)
    ref = fa.attention_bwd_reference(
        *(t.float() for t in (q, k, v)), mask, args[4], args[5],
        dout.float(), softclamp=50.0)
    for got, r in zip((dq, dk, dv), ref):
        assert got.dtype == torch.bfloat16 and got.shape == r.shape
        _check(got, r, 2.0 ** -7)


def test_tensor_core_backward_is_deterministic(cuda):
    """Two bf16 calls of K4 and K5 on the same inputs give bit-equal dq, dk
    and dv: no atomics, every sum in a fixed order."""
    q, k, v, mask, dout = _train_views(cuda, "fused_qkv", 4, 782, 16, 782,
                                       1.0)
    mask[1, 700:] = False
    args = _bwd_args(q, k, v, mask, dout)
    runs = [(fa.attention_bwd_dq(*args, softclamp=50.0),
             *fa.attention_bwd_dkv(*args, softclamp=50.0)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# The captured sampler (V2APipeline._sample / _sample_multipass as CUDA graphs)
# --------------------------------------------------------------------------- #

def _small_bf16_pipeline(device, shipped_cfm: bool = False):
    """A small bf16 pipeline whose heads the tensor-core kernels take (64
    wide; ViT 104), bf16 towers; with ``shipped_cfm`` the sampler is the
    shipped model's (``v2a_default()``'s CFM at full width and depth)."""
    import dataclasses

    from v2ap_torch import config as C
    from v2ap_torch.models.clip_vit import CLIPVisionConfig
    from v2ap_torch.models.t5 import T5Config
    from v2ap_torch.pipelines.generate import V2APipeline

    base = C.v2a_default()
    model = base.model if shipped_cfm else dataclasses.replace(
        base.model, dim=128, depth=2, heads=2, dim_text=128,
        text_heads=2, text_depth=2, dim_frames=128, frames_heads=2,
        dim_context=128, max_seq_len=512)
    cfg = base.replace(
        model=model,
        conditioning=dataclasses.replace(base.conditioning, feature_cache=False))
    clip = CLIPVisionConfig(hidden_size=208, intermediate_size=416,
                            num_layers=2, num_heads=2, image_size=56,
                            projection_dim=model.dim_text)
    t5 = T5Config(vocab_size=1000, d_model=model.dim_context, d_kv=64,
                  d_ff=256, num_layers=2, num_heads=2)
    return V2APipeline(cfg, seed=3, device=device, clip_config=clip,
                       t5_config=t5, quantize_towers=False)


def _sampler_inputs(pipe, b, n=192, n_valid=150, seed=0):
    m = pipe.cfg.model
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=pipe.device)
    mask = (torch.arange(n, device=pipe.device)[None] < n_valid).repeat(b, 1)
    return (r(b, n, m.num_channels), r(b, n, m.dim_text),
            torch.rand(b, n, m.notes, generator=gen, device=pipe.device),
            r(b, 8, m.dim_context).to(torch.bfloat16),
            (torch.arange(8, device=pipe.device)[None] < 5).repeat(b, 1),
            mask)


def _eager(pipe, inputs, sampler):
    x0, text, roll, ctx, cmask, mask = inputs
    with torch.inference_mode():
        return pipe.cfm.sample(x0, text_embed=text, frames_embed=roll,
                               context=ctx, context_mask=cmask, mask=mask,
                               sampler=sampler)


def test_captured_sampler_is_bit_equal_to_eager(cuda):
    """The pipeline's sampler on the card is one captured program per key;
    a replay with new inputs gives the eager trajectory's bits, for the CFG
    sampler, the few-step one and two restart passes; a replay calls no
    wrapper, yet the counters of K1, N1 and N2 get the launches its capture
    recorded, as many as the profiler's trace shows."""
    from torch.profiler import ProfilerActivity, profile

    from v2ap_torch import config as C

    pipe = _small_bf16_pipeline(cuda)
    assert pipe.cfm.to_pred.weight.dtype == torch.bfloat16   # cast once
    cfg_sampler = C.SamplerConfig(steps=6, cfg_strength=2.0)
    few = C.SamplerConfig(steps=3, cfg_strength=0.0, sway_sampling=False)
    for sampler in (cfg_sampler, few):
        first = _sampler_inputs(pipe, 2, seed=1)
        pipe._sample(*first, sampler)                    # captures
        fa.reset_launch_counts()
        second = _sampler_inputs(pipe, 2, seed=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = pipe._sample(*second, sampler)         # replays
            torch.cuda.synchronize()
        k1 = sum(e.count for e in prof.key_averages()
                 if "flash_fwd_sm90_kernel<64>" in e.key)
        assert k1 == (sampler.steps - 1) * 4 * pipe.cfg.model.depth
        assert fa.launch_counts["flash_attention_packed"] == k1
        norms = _norm_launches(pipe.cfg.model, sampler.steps - 1)
        assert {k: fa.launch_counts[k] for k in norms} == norms
        assert _trace_counts(prof) == norms
        assert torch.equal(got, _eager(pipe, second, sampler))
    noises = torch.randn((1, 2, 192, pipe.cfg.model.num_channels),
                         device=cuda)
    x = _sampler_inputs(pipe, 2, seed=3)
    got = pipe._sample_multipass(*x, cfg_sampler, noises, 2, 0.6)
    with torch.inference_mode():
        want = pipe.cfm.sample_multipass(
            x[0], passes=2, restart_t=0.6, noises=noises, text_embed=x[1],
            frames_embed=x[2], context=x[3], context_mask=x[4], mask=x[5],
            sampler=cfg_sampler)
    assert torch.equal(got, want)
    assert len(pipe.graphs) == 3


def test_new_batch_size_captures_a_second_program(cuda):
    """Batch 1 and batch 3 at one bucket are two programs (batch 3 runs
    padded to 4, its rows bit-equal to the eager sampler on the padded
    batch); batch 4 replays batch 3's program and batch 1 its own (no new
    capture)."""
    from v2ap_torch import config as C
    from v2ap_torch.utils.jitting import pad_batch

    pipe = _small_bf16_pipeline(cuda)
    sampler = C.SamplerConfig(steps=4, cfg_strength=2.0)
    one = _sampler_inputs(pipe, 1, seed=4)
    three = _sampler_inputs(pipe, 3, seed=5)
    pipe._sample(*one, sampler)
    assert len(pipe.graphs) == len(pipe.graphs.captures) == 1
    got3 = pipe._sample(*three, sampler)
    assert got3.shape[0] == 3
    assert len(pipe.graphs) == len(pipe.graphs.captures) == 2
    got4 = pipe._sample(*_sampler_inputs(pipe, 4, seed=7), sampler)
    got1 = pipe._sample(*_sampler_inputs(pipe, 1, seed=6), sampler)
    assert len(pipe.graphs.captures) == 2
    assert torch.equal(got3, _eager(pipe, tuple(pad_batch(t, 4)
                                                for t in three), sampler)[:3])
    assert torch.equal(got4, _eager(pipe, _sampler_inputs(pipe, 4, seed=7),
                                    sampler))
    assert torch.equal(got1, _eager(pipe, _sampler_inputs(pipe, 1, seed=6),
                                    sampler))


def test_concurrent_callers_get_their_own_results(cuda):
    """Threads sampling through one program at once (the HTTP server's
    handlers) each get the eager result of their own inputs: a call's
    copy into the static buffers, replay and output copy are not
    interleaved with another's."""
    import threading

    from v2ap_torch import config as C

    pipe = _small_bf16_pipeline(cuda)
    sampler = C.SamplerConfig(steps=4, cfg_strength=2.0)
    inputs = [_sampler_inputs(pipe, 2, seed=10 + i) for i in range(4)]
    pipe._sample(*inputs[0], sampler)                 # capture first
    got = {}

    def work(i):
        for _ in range(3):
            got[i] = pipe._sample(*inputs[i], sampler)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(got[i], _eager(pipe, inputs[i], sampler)), i


def test_failed_capture_raises_instead_of_running_eagerly(cuda):
    """A velocity field that synchronises with the host cannot be captured:
    the pipeline raises and keeps no program, it does not fall back to the
    eager loop; the device's default generator draws again afterwards."""
    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM

    class HostSyncingCFM(CFM):
        def pred_head(self, x, *args, **kw):
            float(x.abs().sum())                # a host sync
            return super().pred_head(x, *args, **kw)

    pipe = _small_bf16_pipeline(cuda)
    pipe.cfm.__class__ = HostSyncingCFM
    with pytest.raises(RuntimeError, match="capturing the program"):
        pipe._sample(*_sampler_inputs(pipe, 1, seed=7),
                     C.SamplerConfig(steps=3, cfg_strength=2.0))
    assert len(pipe.graphs) == 0
    torch.cuda.synchronize()
    state = torch.cuda.get_rng_state(cuda)
    a = torch.randn(4, device=cuda)
    torch.cuda.set_rng_state(state, cuda)
    assert torch.equal(torch.randn(4, device=cuda), a)


# --------------------------------------------------------------------------- #
# The fused norms: N1 rms_norm, N2 gated_residual (ops/norms.py, norms.cu)
# --------------------------------------------------------------------------- #

def _norm_launches(cfg, forwards: int, cross: bool = True) -> dict:
    """N1 and N2 launches of ``forwards`` transformer forwards without
    autograd: per audio layer the attention, cross-attention (where it
    runs) and FF norm and gate; two norms per text and frames layer; the
    final norm."""
    audio = cfg.depth * (3 if cross else 2)
    return {"rms_norm": forwards * (audio + 2 * cfg.text_depth
                                    + 2 * cfg.depth + 1),
            "gated_residual": forwards * audio}


def _trace_counts(prof) -> dict:
    """N1 and N2 launches in a profiler's trace, by kernel name."""
    events = prof.key_averages()
    return {name: sum(e.count for e in events if f"{name}_kernel" in e.key)
            for name in ("rms_norm", "gated_residual")}


def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in bf16 steps (ulps) between two bf16 tensors."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


NORM_CASES = [
    # (b, n, d, gain, first row of the view): a CFG evaluation's rows of the
    # three streams (2 x 832 here, 2 x 800 at the 768-latent bucket), a
    # batch of 8 clips' (16 x 832), final_norm's x[:, 32:] view, a width
    # that leaves lanes idle and one past the register variants
    pytest.param((2, 832, 1024, "g", 0), id="audio_1664x1024_g"),
    pytest.param((2, 832, 1280, "g", 0), id="clip_1664x1280_g"),
    pytest.param((2, 832, 512, "g", 0), id="roll_1664x512_g"),
    pytest.param((2, 832, 1024, "gamma", 0), id="audio_1664x1024_gamma"),
    pytest.param((16, 832, 1024, "gamma", 0), id="batch_13312x1024_gamma"),
    pytest.param((2, 832, 1024, "g", 32), id="final_norm_x_32_view"),
    pytest.param((3, 70, 136, "gamma", 0), id="ragged_lanes_136"),
    pytest.param((2, 40, 2560, "g", 0), id="wide_2560_reread"),
]


def _gamma_slot(b, d, device, seed):
    """A strided (b, d) slot of a fused (depth, b, slots, d) projection, as
    ``TriStreamTransformer._fused_cond_gammas`` hands it to a block."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fused = torch.randn(b, 12, 6, d, generator=gen, device=device)
    return fused.permute(1, 0, 2, 3)[5][:, 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", NORM_CASES)
def test_rms_norm_kernel_matches_plain(cuda, case, dtype):
    """N1 against its plain version on the same inputs on the card: bf16
    within one bf16 step (only the order of the sum of squares differs),
    f32 within 1e-5 x max(1, |ref|); one launch counted. A zero row takes
    the eps floor."""
    from v2ap_torch.ops import norms

    b, n, d, gain, start = case
    gen = torch.Generator(device=cuda).manual_seed(d + b)
    x = (torch.randn(b, n + start, d, generator=gen, device=cuda) * 3
         ).to(dtype)[:, start:]
    x[0, 1] = 0
    g, gamma = None, None
    if gain == "g":
        g = torch.randn(d, generator=gen, device=cuda)
    else:
        gamma = _gamma_slot(b, d, cuda, d)
    before = dict(fa.launch_counts)
    got = norms.rms_norm(x, g, gamma=gamma)
    ref = norms.rms_norm_reference(x, g, gamma=gamma)
    torch.cuda.synchronize()
    assert fa.launch_counts["rms_norm"] == before["rms_norm"] + 1
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.isfinite(got).all() and not got[0, 1].any()
    if dtype == torch.bfloat16:
        assert _bf16_steps(got, ref) <= 1
    else:
        err = (got - ref).abs() / ref.abs().clamp(min=1.0)
        assert err.max().item() <= 1e-5


GATE_CASES = [
    # (b, n, d, branch row stride): the audio stream's gates
    pytest.param((2, 832, 1024, 1024), id="audio_1664x1024"),
    pytest.param((16, 832, 1024, 1024), id="batch_13312x1024"),
    pytest.param((2, 832, 1024, 3072), id="strided_branch"),
    pytest.param((3, 70, 136, 136), id="ragged_lanes_136"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GATE_CASES)
def test_gated_residual_kernel_is_bit_equal_to_plain(cuda, case, dtype):
    """N2 against ``x + AdaLNZero(branch)`` on the same inputs on the card:
    bit-equal (the same two roundings, the same sigmoid); one launch
    counted."""
    from v2ap_torch.ops import norms

    b, n, d, row = case
    gen = torch.Generator(device=cuda).manual_seed(d + b + row)
    x = torch.randn(b, n, d, generator=gen, device=cuda).to(dtype)
    branch = (torch.randn(b, n, row, generator=gen, device=cuda) * 4
              ).to(dtype)[..., :d]
    gamma = _gamma_slot(b, d, cuda, row) * 3
    gate = norms.AdaLNZero(d, device=cuda)
    before = dict(fa.launch_counts)
    got = gate.residual(x, branch, gamma=gamma)
    want = x + gate(branch, gamma=gamma)
    torch.cuda.synchronize()
    assert fa.launch_counts["gated_residual"] == \
        before["gated_residual"] + 1
    assert got.dtype == dtype and torch.equal(got, want)


def test_norm_kernels_refuse_what_they_do_not_take(cuda):
    """On a CUDA tensor without autograd the wrappers launch or raise; they
    never take the plain version."""
    from v2ap_torch.ops import norms

    before = dict(fa.launch_counts)
    x = torch.zeros(2, 8, 20, device=cuda)                  # width 20
    with pytest.raises(ValueError, match="multiple of 8"):
        norms.rms_norm(x, torch.ones(20, device=cuda))
    h = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norms.rms_norm(h, torch.ones(16, device=cuda))
    odd = torch.zeros(2, 8, 17, device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        norms.rms_norm(odd, torch.ones(16, device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        norms.gated_residual(odd, odd, torch.zeros(2, 16, device=cuda))
    with pytest.raises(ValueError, match="per-batch-row"):
        norms.rms_norm(torch.zeros(2, 8, 16, device=cuda),
                       gamma=torch.zeros(2, 8, 16, device=cuda))
    assert fa.launch_counts == before


def test_norms_under_autograd_take_the_plain_path(cuda):
    """Where autograd needs the gradient (training) the modules run the
    plain versions on the card: nothing launches, and the output and the
    gradients of x, the branch and every parameter equal those of the
    plain functions, bit for bit."""
    from v2ap_torch.ops import norms

    d = 1024
    torch.manual_seed(0)
    norm = norms.RMSNorm(d, device=cuda)
    adaptive = norms.AdaptiveRMSNorm(d, device=cuda)
    gate = norms.AdaLNZero(d, device=cuda)
    with torch.no_grad():
        norm.g.normal_()
        adaptive.to_gamma.weight.normal_(std=0.02)
        gate.to_gamma.weight.normal_(std=0.02)
    cond = torch.randn(2, d, device=cuda)
    x0 = torch.randn(2, 64, d, device=cuda).to(torch.bfloat16)
    br0 = torch.randn(2, 64, d, device=cuda).to(torch.bfloat16)
    params = [norm.g, adaptive.to_gamma.weight, gate.to_gamma.weight,
              gate.to_gamma.bias]

    def run(modules: bool):
        x, br = (t.clone().requires_grad_(True) for t in (x0, br0))
        for p in params:
            p.grad = None
        if modules:
            y = adaptive(norm(gate.residual(x, br, condition=cond)),
                         condition=cond)
        else:
            y = norms.gated_residual_reference(
                x, br, gate.to_gamma(cond[:, None, :].float()))
            y = norms.rms_norm_reference(y, norm.g)
            y = norms.rms_norm_reference(
                y, gamma=adaptive.to_gamma(cond.float()))
        y.float().square().sum().backward()
        return [y, x.grad, br.grad] + [p.grad for p in params]

    fa.reset_launch_counts()
    got = run(modules=True)
    torch.cuda.synchronize()
    assert fa.launch_counts == dict.fromkeys(fa.launch_counts, 0)
    for a, b in zip(got, run(modules=False)):
        assert a is not None and torch.equal(a, b)


def test_replayed_v2a_sampler_launches_2040_norms(cuda):
    """The shipped model's 25-step CFG sampler (``v2a_default()``'s CFM at
    full width, one 10 s clip: the 768-latent bucket, the empty prompt's
    one context key) replayed from its captured program: 24 evaluations x
    85 norms = 2040 N1 launches and 24 x 36 = 864 N2 by the counters. (The
    profiler's trace of a bare replay of ~57 000 kernels once lost 46 of
    these records; the trace is held to the counters in the small
    captured-sampler test above and in ``chip_smoke.py``'s profiles.)"""
    from v2ap_torch import config as C

    pipe = _small_bf16_pipeline(cuda, shipped_cfm=True)
    sampler = C.SamplerConfig()
    assert (sampler.steps, sampler.cfg_strength) == (25, 2.0)
    inputs = _sampler_inputs(pipe, 1, n=768, n_valid=750)
    ctx, cmask = inputs[3][:, :1], inputs[4][:, :1]
    inputs = inputs[:3] + (ctx, cmask) + inputs[5:]
    pipe._sample(*inputs, sampler)                       # captures
    fa.reset_launch_counts()
    got = pipe._sample(*inputs, sampler)                 # replays
    torch.cuda.synchronize()
    want = {"rms_norm": 2040, "gated_residual": 864}
    assert _norm_launches(pipe.cfg.model, 24) == want
    assert {k: fa.launch_counts[k] for k in want} == want
    assert torch.isfinite(got).all()


# --------------------------------------------------------------------------- #
# The int8 Linear's kernels: Q1 quantize, Q2 dequantize (utils/quantize.py,
# quantize.cu)
# --------------------------------------------------------------------------- #

# (m, k, n): ViT-bigG's served products on a 64-frame chunk (16 448 tokens)
# and on the 20-frame tail of a 10 s clip at stride 3 (5140), the visual
# projection of 64 class tokens; then the edges: m <= 16, k and n off the
# multiple of 8, float32's k = 4 mod 8, a row wider than 8 warps hold (Q1's
# scalar route)
INT8_CASES = [
    pytest.param((16448, 1664, 1664), id="bigg_qkvo"),
    pytest.param((16448, 1664, 8192), id="bigg_fc1"),
    pytest.param((16448, 8192, 1664), id="bigg_fc2"),
    pytest.param((5140, 1664, 8192), id="tail_fc1"),
    pytest.param((5140, 8192, 1664), id="tail_fc2"),
    pytest.param((64, 1664, 1280), id="visual_projection"),
    pytest.param((1, 1664, 1280), id="m1"),
    pytest.param((16, 40, 51), id="m16_k40_n51"),
    pytest.param((37, 1663, 1661), id="k1663_n1661"),
    pytest.param((300, 1668, 1028), id="k1668"),
    pytest.param((40, 20000, 24), id="k20000_wide"),
]


def _int8_inputs(m, k, n, dtype, device, seed=0):
    """x (m, k) over many binades with a zero first row and a last row of
    one huge value, weight (n, k) at a tower's scale with a zero row, bias
    (n,)."""
    gen = torch.Generator(device=device).manual_seed(seed + m + k + n)
    x = torch.randn(m, k, generator=gen, device=device) * torch.exp2(
        torch.randint(-12, 8, (m, 1), generator=gen, device=device).float())
    x[-1, k // 2] = 3e4
    x[0] = 0.0
    w = torch.randn(n, k, generator=gen, device=device) / k ** 0.5
    w[n // 2] = 0.0
    b = torch.randn(n, generator=gen, device=device) * 0.02
    return x.to(dtype), w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_kernels_are_bit_equal_to_the_plain_chain(cuda, case, dtype):
    """Q1 on the activation and on the weight against ``quantize_rows``
    (codes and scales bit-equal, the padding to ``torch._int_mm``'s shape
    zero), Q2 against ``dequantize`` on the same int32 sums with and
    without a bias, and ``Linear(int8)`` against the plain chain: all bit
    for bit on the card, two Q1 and one Q2 launch a call."""
    from v2ap_torch.ops.layers import Linear
    from v2ap_torch.utils import quantize as q

    m, k, n = case
    x, w, b = _int8_inputs(m, k, n, dtype, cuda)
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    before = dict(fa.launch_counts)
    qx, sx = q.quantize_rows_padded(x, mp)
    qw, sw = q.quantize_rows_padded(w, np_)
    for (codes, scale), t, rows in (((qx, sx), x, mp), ((qw, sw), w, np_)):
        want_codes, want_scale = q.quantize_rows(t)
        assert codes.shape == (rows, kp) and scale.shape == want_scale.shape
        assert torch.equal(codes[:t.shape[0], :k], want_codes)
        assert not codes[t.shape[0]:].any() and not codes[:, k:].any()
        assert scale.dtype == dtype and torch.equal(scale, want_scale)
    acc = torch._int_mm(qx, qw.t())
    for bias in (b, None):
        got = q.dequantize_padded(acc, sx, sw, bias, m, n)
        assert got.shape == (m, n) and got.is_contiguous()
        assert torch.equal(got, q.dequantize(acc[:m, :n], sx, sw, bias))
    lin = Linear(k, n, dtype=dtype, device=cuda)
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.copy_(b)
    q.quantize_linears_int8(lin)
    with torch.inference_mode():
        y = lin(x)
    torch.cuda.synchronize()
    assert torch.equal(y, q.int8_linear_reference(x, w, b))
    assert torch.equal(y[0], b) and torch.isfinite(y).all()
    assert fa.launch_counts["int8_quantize"] == before["int8_quantize"] + 4
    assert fa.launch_counts["int8_dequantize"] == \
        before["int8_dequantize"] + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_kernels_on_views_and_edge_rows(cuda, dtype):
    """The scalar routes and the edges, bit-equal to the plain chain: a
    3-D input whose rows are a strided, misaligned view (Q1's scalar
    route), a bias that is a strided view (Q2's scalar route), rows of all
    zeros, of one huge value, of subnormals, of values at the clip."""
    from v2ap_torch.utils import quantize as q

    gen = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn(3, 50, 1700, generator=gen, device=cuda).to(dtype)
    x = base[:, ::2, 1:1665]                      # (3, 25, 1664) view
    x[0, 0] = 0
    x[0, 1] = 0
    x[0, 1, 5] = 6e4
    x[0, 2] = torch.finfo(dtype).tiny / 4
    x[0, 3, :4] = torch.tensor([126.75, -127.25, 127.5, -0.5])
    w = (torch.randn(1288, 1664, generator=gen, device=cuda) / 40).to(dtype)
    b = torch.randn(1288, 2, generator=gen, device=cuda).to(dtype)[:, 1]
    assert not q._vector_rows(x.reshape(-1, 1664))
    assert not q._vector_bias(b, 1288, x.element_size())
    with torch.inference_mode():
        got = q.int8_linear(x, w, b)
    want = q.int8_linear_reference(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == (3, 25, 1288) and torch.equal(got, want)


def test_int8_linear_refuses_what_it_does_not_take(cuda):
    """The kernel path raises, launching nothing, on float16, mixed dtypes,
    a weight of another width, a tensor on the CPU beside one on the card
    and a call that needs a gradient; it does not fall back."""
    from v2ap_torch.utils import quantize as q

    bf = torch.bfloat16
    x = torch.randn(32, 64, device=cuda, dtype=bf)
    w = torch.randn(16, 64, device=cuda, dtype=bf)
    before = dict(fa.launch_counts)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        q.int8_linear(x.half(), w.half())
    with pytest.raises(TypeError, match="differ"):
        q.int8_linear(x, w.float())
    with pytest.raises(ValueError, match="product"):
        q.int8_linear(x, w[:, :60])
    with pytest.raises(ValueError, match="different devices"):
        q.int8_linear(x, w.cpu())
    with pytest.raises(RuntimeError, match="no gradient"):
        q.int8_linear(x, w.clone().requires_grad_())
    assert fa.launch_counts == before


def test_captured_int8_linear_counts_its_launches_on_replay(cuda):
    """Q1 and Q2 inside a captured CUDA graph (the int8 CFM's sampler):
    each replay gives the eager call's bits and adds the capture's two Q1
    and one Q2 launches a Linear to the counters."""
    from v2ap_torch.ops.layers import Linear
    from v2ap_torch.utils import quantize as q
    from v2ap_torch.utils.jitting import CapturedPrograms

    torch.manual_seed(0)
    lins = [Linear(1024, 1024, dtype=torch.bfloat16, device=cuda),
            Linear(1024, 51, dtype=torch.bfloat16, device=cuda)]
    for lin in lins:
        q.quantize_linears_int8(lin)

    def fn(x):
        return lins[1](torch.nn.functional.gelu(lins[0](x)))

    x = torch.randn(2, 800, 1024, device=cuda).to(torch.bfloat16)
    progs = CapturedPrograms()
    with torch.inference_mode():
        want = fn(x)
        progs.run("int8", fn, (x,))                      # warm-up, capture
        fa.reset_launch_counts()
        for _ in range(3):
            got = progs.run("int8", fn, (x,))
            assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert fa.launch_counts["int8_quantize"] == 3 * 4
    assert fa.launch_counts["int8_dequantize"] == 3 * 2


def _v2p_batch(cfg, b=2, n=24, nc=6, seed=5):
    """A V2P batch on the card: ragged lens and context, keyboard strips
    at the roll rate, a binary ground-truth roll."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {"latents": r(b, n, cfg.num_channels),
            "lens": torch.tensor([n, n - 5]),
            "text_embed": r(b, n, cfg.dim_text),
            "context": r(b, nc, cfg.dim_context),
            "context_mask": torch.arange(nc)[None] < torch.tensor([[nc], [3]]),
            "frames": torch.from_numpy(rng.random(
                (b, n // 3 + 1, 100, 900)).astype(np.float32)),
            "midis": torch.from_numpy(
                (rng.random((b, n, cfg.notes)) > 0.7).astype(np.float32))}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_no_remat_in_bf16(cuda, policy):
    """A bf16 V2P loss at dropout 0.1 on the card: remat gives the loss and
    gradients of the same step without it (the recompute draws the
    forward's dropout masks from the CFM's CUDA generator), within 1e-5 of
    each gradient's scale (the embedding's and convolutions' backward sum
    with atomics in any order; cuDNN deterministic otherwise), and
    launches K3 twice as often, K4 and K5 as often."""
    import dataclasses

    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM, draw_loss_randoms

    base = C.tiny_test()
    cfg = dataclasses.replace(base.model, dtype="bfloat16", dropout=0.1)
    torch.manual_seed(0)
    plain = CFM(cfg, base.conditioning, with_video2roll=True, device=cuda)
    remat = CFM(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                base.conditioning, with_video2roll=True, device=cuda)
    remat.load_state_dict(plain.state_dict())
    batch = {k: v.to(cuda) for k, v in _v2p_batch(cfg).items()}
    b, n, c = batch["latents"].shape
    draws = draw_loss_randoms(b, n, c, base.conditioning.frac_lengths_mask,
                              generator=torch.Generator().manual_seed(1),
                              device=cuda)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, model in (("plain", plain), ("remat", remat)):
            model.dropout_generator.manual_seed(9)
            fa.reset_launch_counts()
            loss = model.loss(batch["latents"], lens=batch["lens"],
                              text_embed=batch["text_embed"],
                              context=batch["context"],
                              context_mask=batch["context_mask"],
                              frames=batch["frames"], midis=batch["midis"],
                              draws=draws).loss
            loss.backward()
            torch.cuda.synchronize()
            out[name] = (loss.item(), dict(fa.launch_counts),
                         {k: p.grad for k, p in model.named_parameters()
                          if p.grad is not None},
                         model.dropout_generator.get_state())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, c0, g0, s0), (l1, c1, g1, s1) = out["plain"], out["remat"]
    assert np.isfinite(l0) and l1 == pytest.approx(l0, rel=1e-6)
    assert torch.equal(s0, s1)
    assert c1 == {**c0, "flash_attention_lse": 2 * c0["flash_attention_lse"]}
    assert c0["flash_attention_lse"] == 4 * cfg.depth
    assert set(g0) == set(g1) and any(k.startswith("video2roll") for k in g0)
    for k, g in g0.items():
        tol = 1e-5 * max(1.0, g.abs().max().item())
        assert (g1[k] - g).abs().max().item() <= tol, k


def test_checkpoint_round_trip_on_cuda(cuda, tmp_path):
    """Two V2P steps of a bf16 tiny trainer with EMA on the card, a
    checkpoint, a fresh trainer restored from it: parameters, buffers, AdamW
    moments and count, EMA and the CUDA dropout generator bit-equal, and
    the next step finite."""
    import dataclasses

    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.training import Trainer
    from v2ap_torch.utils.checkpoint import CheckpointManager

    base = C.tiny_test()
    cfg = dataclasses.replace(base.model, dtype="bfloat16")
    tcfg = C.TrainConfig(learning_rate=1e-3, warmup_steps=2, use_ema=True)
    torch.manual_seed(0)
    trainer = Trainer(CFM(cfg, base.conditioning, with_video2roll=True,
                          device=cuda), tcfg)
    batch = _v2p_batch(cfg)
    for _ in range(2):
        trainer.train_step(batch)
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=1)
    mgr.save(trainer.step, trainer)
    torch.manual_seed(1)
    fresh = Trainer(CFM(cfg, base.conditioning, with_video2roll=True,
                        device=cuda), tcfg)
    assert mgr.restore(fresh) == 2 == fresh.step
    a, b = trainer.state_dict(), fresh.state_dict()
    for k, v in a["model"].items():
        assert v.is_cuda and torch.equal(v, b["model"][k]), k
    for k, v in a["ema"].items():
        assert torch.equal(v, b["ema"][k]), k
    assert torch.equal(a["rng"], b["rng"])
    assert fresh.model.dropout_generator.device.type == "cuda"
    for i, st in a["opt"]["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["opt"]["adamw"]["state"][i][k]), (i, k)
    assert a["opt"]["count"] == b["opt"]["count"] == 2
    loss, _ = fresh.train_step(batch)
    assert torch.isfinite(loss)


# the card's bf16 DPO + FactorCL step against the CPU's f32 one, per tensor;
# the limits are set from the card's readings (see the test's docstring)
DPO_GRAD_REL = 0.25
DPO_UPDATE_REL = 1e-3


def _rms(t) -> float:
    return t.detach().float().cpu().pow(2).mean().sqrt().item()


def _dpo_factorcl_readings(device) -> dict:
    """One ``Trainer`` step with DPO and FactorCL at learning rate 1e-2
    (Adam's first update -1e-4 * sign(g) after the warm-up's 0.01 factor)
    on ``device`` in bf16 and on the CPU in f32, from the same weights,
    EMA shadow (set apart from the model, so the reference scores differ)
    and draws; and the CPU step once more without its DPO term. Returns
    the loss terms, the global gradient norms, the card's launch counts,
    and per tensor of the CFM ("cfm.<name>") and FactorCL ("fcl.<name>"):

      * ``grad``: RMS of the card's minus the CPU's (clipped) gradient over
        the CPU gradient's RMS, floored at 1e-3 of the module's largest
        (a gradient that is 0, or cancels to rounding noise, is held to
        that floor); ``grad_without_dpo`` the same for the CPU step
        without DPO;
      * ``update``, ``zero_update``, ``flipped_update``: the relative RMS
        of the card's update (after minus before), a zero one and the
        negated CPU update against the CPU's, over the elements whose CPU
        gradient exceeds a tenth of its tensor's RMS and where the card's
        has the same sign within half of it (there Adam's first update,
        -lr * sign(g) less the weight decay, must agree; None where no
        element qualifies);

    and the card's EMA shadow against decay * before + (1 - decay) * after
    (relative RMS per tensor)."""
    import dataclasses

    from v2ap_torch import config as C
    from v2ap_torch.models.cfm import CFM, draw_loss_randoms
    from v2ap_torch.training import Trainer

    base = C.tiny_test()
    cfg = dataclasses.replace(base.model, dropout=0.0, depth=2, text_depth=2)
    tcfg = C.TrainConfig(learning_rate=1e-2, warmup_steps=2, ema_decay=0.9,
                         dpo=True, contrastive=True)
    torch.manual_seed(0)
    cpu = Trainer(CFM(cfg, base.conditioning, device="cpu"), tcfg)
    card = Trainer(CFM(dataclasses.replace(cfg, dtype="bfloat16"),
                       base.conditioning, device=device), tcfg)
    no_dpo = Trainer(CFM(cfg, base.conditioning, device="cpu"),
                     dataclasses.replace(tcfg, dpo=False))
    for t in (card, no_dpo):
        t.model.load_state_dict(cpu.model.state_dict())
        t.fcl.load_state_dict(cpu.fcl.state_dict())
    with torch.no_grad():
        for name, s in cpu.ema.shadow.items():
            s.add_(torch.randn_like(s) * 0.01)
            card.ema.shadow[name].copy_(s)
    shadow = {k: s.clone() for k, s in card.ema.shadow.items()}

    def params(t):
        return {m: dict(mod.named_parameters())
                for m, mod in (("cfm", t.model), ("fcl", t.fcl))}

    before = {m: {k: p.detach().clone() for k, p in ps.items()}
              for m, ps in params(cpu).items()}
    b, n, nc = 8, 40, 6
    rng = np.random.default_rng(6)
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    batch = {"latents": r(b, n, cfg.num_channels),
             "lens": torch.tensor([n, n - 9] + [n] * (b - 2)),
             "text_embed": r(b, n, cfg.dim_text),
             "context": r(b, nc, cfg.dim_context),
             "context_mask": torch.arange(nc)[None] < torch.tensor(
                 [[3]] + [[nc]] * (b - 1))}
    draws = draw_loss_randoms(b, n, cfg.num_channels,
                              base.conditioning.frac_lengths_mask,
                              generator=torch.Generator().manual_seed(2))
    ft = torch.tensor(17)
    fa.reset_launch_counts()
    loss_g, bk_g = card.train_step(batch, draws=draws._replace(
        **{f: getattr(draws, f).to(device) for f in draws._fields}),
        feature_t=ft)
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    loss_c, bk_c = cpu.train_step(batch, draws=draws, feature_t=ft)
    no_dpo.train_step(batch, draws=draws, feature_t=ft)

    got, want, alt = params(card), params(cpu), params(no_dpo)
    tensors = {}
    for m, ps in want.items():
        floor = 1e-3 * max(_rms(p.grad) for p in ps.values())
        for name, p in ps.items():
            g = p.grad
            g_card = got[m][name].grad.detach().float().cpu()
            den = max(_rms(g), floor)
            big = g.abs() > 0.1 * _rms(g)
            agree = big & (g_card.sign() == g.sign()) & (
                (g_card - g).abs() < 0.5 * g.abs())
            upd = (p.detach() - before[m][name])[agree]
            card_upd = (got[m][name].detach().float().cpu()
                        - before[m][name])[agree]
            rel = lambda x: (_rms(x - upd) / _rms(upd) if agree.any()
                             else None)
            tensors[f"{m}.{name}"] = dict(
                grad=_rms(g_card - g) / den,
                grad_without_dpo=_rms(alt[m][name].grad - g) / den,
                update=rel(card_upd), zero_update=rel(torch.zeros_like(upd)),
                flipped_update=rel(-upd))
    ema = {k: _rms(s - (0.9 * shadow[k] + 0.1 * got["cfm"][k].detach()))
           / _rms(s) for k, s in card.ema.shadow.items()}
    return dict(counts=counts, depth=cfg.depth, model=cfg,
                terms={k: (float(g), float(c)) for k, g, c in (
                    ("loss", loss_g, loss_c), ("flow", bk_g.flow, bk_c.flow),
                    ("dpo", bk_g.dpo, bk_c.dpo),
                    ("contrastive", bk_g.contrastive, bk_c.contrastive),
                    ("grad_norm", card.last_grad_norm, cpu.last_grad_norm))},
                tensors=tensors, ema=ema)


def test_dpo_factorcl_step_in_bf16_tracks_the_cpu(cuda):
    """One ``Trainer`` step with DPO and FactorCL (EMA shadow apart from the
    model, 8 rows, the pair in the last two, dropout 0) in bf16 on the card
    against the same step in f32 on the CPU, from the same weights and
    draws (``_dpo_factorcl_readings``). The DPO reference forward runs
    without autograd, so K1 launches once per attention, N1 and N2 once
    per norm and gate, beside the policy's K3, K4 and K5. Held per tensor
    of the CFM and FactorCL:

      * the clipped gradients within ``DPO_GRAD_REL`` relative RMS: this
        checks the bf16 backward of the DPO and FactorCL path. On an H100
        the readings ran to 0.14: a cross-attention gate bias whose DPO
        and flow gradients cancel to a ninth of either, then FactorCL's
        heads and the text stream it reaches (up to 0.11), whose CLUB
        bound is a difference of nearly equal scores (the contrastive term
        itself moves by 1.2% in bf16); the rest of the CFM 4e-3 to 2.2e-2.
        The same step without its DPO term reads 0.56 to 9 on every CFM
        tensor that has a gradient, so the check sees the term;
      * Adam's update within ``DPO_UPDATE_REL`` where the two gradients
        agree (the readings ran to 9.4e-5, the f32 rounding of p + 1e-4 at
        |p| ~ 1); a zero update reads 1 and a sign-flipped one 2;
      * the card's EMA shadow equal to decay * before + (1 - decay) *
        after within 1e-6 (readings to 3e-8);

    and the loss terms and the global gradient norm within 2e-2 (a bf16
    forward)."""
    rd = _dpo_factorcl_readings(cuda)
    per_step = 4 * rd["depth"]
    assert rd["counts"] == {
        **dict.fromkeys(rd["counts"], 0),
        "flash_attention_packed": per_step, "flash_attention_lse": per_step,
        "flash_attention_bwd_dq": per_step,
        "flash_attention_bwd_dkv": per_step, **_norm_launches(rd["model"], 1)}
    for key in ("loss", "flow", "dpo", "grad_norm"):
        got, want = rd["terms"][key]
        assert abs(got - want) <= 2e-2 * abs(want), key
    got, want = rd["terms"]["contrastive"]
    assert abs(got - want) <= 2e-2 and got != 0.0
    tensors = rd["tensors"]
    bad = {k: v["grad"] for k, v in tensors.items()
           if not v["grad"] < DPO_GRAD_REL}
    assert not bad, bad
    without = [v["grad_without_dpo"] for k, v in tensors.items()
               if k.startswith("cfm.") and v["update"] is not None]
    assert float(np.median(without)) > DPO_GRAD_REL
    updated = {k: v for k, v in tensors.items() if v["update"] is not None}
    assert len(updated) > len(tensors) // 2
    bad = {k: v["update"] for k, v in updated.items()
           if not v["update"] < DPO_UPDATE_REL}
    assert not bad, bad
    for v in updated.values():
        assert min(v["zero_update"], v["flipped_update"]) > DPO_UPDATE_REL
    bad = {k: v for k, v in rd["ema"].items() if not v < 1e-6}
    assert not bad, bad


# ------------------------------------------------------------- evaluators

def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def test_cnn14_on_the_card_tracks_the_cpu(cuda, monkeypatch):
    """The full-width Cnn14 (pann_16k, 527 classes), seeded, on the card
    and on the CPU from the same weights: embedding and logits of a 2 s
    clip within 1e-3 relative RMS (f32 convolutions by cuDNN, TF32 off)."""
    from v2ap_torch.evaluation.pann import Cnn14, pann_16k

    _no_tf32(monkeypatch)
    torch.manual_seed(0)
    cpu = Cnn14(pann_16k(), device="cpu").eval()
    card = Cnn14(pann_16k(), device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    wav = torch.from_numpy((np.random.default_rng(0).normal(size=(1, 32_000))
                            * 0.1).astype(np.float32))
    with torch.no_grad():
        e_cpu, e_card = cpu(wav), card(wav.to(cuda))
        l_cpu, l_card = cpu.logits(wav), card.logits(wav.to(cuda))
    assert e_card.shape == (1, 2048) and l_card.shape == (1, 527)
    assert _rel_rms(e_card, e_cpu) < 1e-3
    assert _rel_rms(l_card, l_cpu) < 1e-3


def test_clap_on_the_card_tracks_the_cpu(cuda, monkeypatch):
    """clap_htsat_unfused(), seeded, on the card and on the CPU from the
    same weights: the audio features of a 10 s clip (1001 frames, resized
    to 1024), the text features of a padded caption within 1e-3 relative
    RMS, their similarity within 1e-4."""
    from v2ap_torch.evaluation.clap_scorer import _fallback_tokenize
    from v2ap_torch.models.clap import ClapModel, clap_htsat_unfused, clap_logmel

    _no_tf32(monkeypatch)
    a, t = clap_htsat_unfused()
    torch.manual_seed(0)
    cpu = ClapModel(a, t, device="cpu").eval()
    card = ClapModel(a, t, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    wav = (np.random.default_rng(1).normal(size=(1, 480_000)) * 0.1
           ).astype(np.float32)
    feats = clap_logmel(wav)
    assert feats.shape == (1, 1, 1001, 64)
    ids, mask = (torch.from_numpy(x).long() for x in
                 _fallback_tokenize(["a dog barks in the rain"], t.vocab_size))
    with torch.no_grad():
        fa_cpu = cpu.get_audio_features(feats)
        fa_card = card.get_audio_features(feats.to(cuda))
        ft_cpu = cpu.get_text_features(ids, mask)
        ft_card = card.get_text_features(ids.to(cuda), mask.to(cuda))
    assert _rel_rms(fa_card, fa_cpu) < 1e-3
    assert _rel_rms(ft_card, ft_cpu) < 1e-3
    s_cpu = (fa_cpu * ft_cpu).sum(-1)
    s_card = (fa_card * ft_card).sum(-1).cpu()
    assert abs(float(s_card - s_cpu)) < 1e-4


# ------------------------------------------------------------- Audeo

def test_batchnorm_train_mode_on_the_card_tracks_the_cpu(cuda):
    """``BatchNorm2d(train=True)`` (the Audeo trainers' mode) on the card and
    on the CPU from the same statistics: the output within 1e-5, the running
    mean and variance after two calls within 1e-6 (float64 sums on both)."""
    from v2ap_torch.ops.layers import BatchNorm2d

    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(8, 16, 20, 30, generator=gen) * 3 + 2 for _ in range(2)]
    cpu = BatchNorm2d(16, eps=0.8, device="cpu")
    with torch.no_grad():
        cpu.weight.normal_(generator=gen)
        cpu.bias.normal_(generator=gen)
    card = BatchNorm2d(16, eps=0.8, device=cuda)
    card.load_state_dict(cpu.state_dict())
    for x in xs:
        want = cpu(x, train=True)
        got = card(x.to(cuda), train=True)
        assert (got.cpu() - want).abs().max().item() < 1e-5
    for name in ("running_mean", "running_var"):
        assert (card.get_buffer(name).cpu() - cpu.get_buffer(name)
                ).abs().max().item() < 1e-6


# ------------------------------------------------------------- towers

def test_dinov2_bf16_attention_products_on_the_tensor_cores(cuda):
    """DINOv2's two attention products in bf16 on the card (float32
    accumulation and result, ``out_dtype``) against the same bf16 values
    widened to float32 with TF32 off: within 1e-5 relative RMS (summation
    order only); then a bf16 attention layer on the card against the CPU
    from the same weights, within 2^-8 relative RMS (one bf16 rounding of
    its products and output)."""
    from v2ap_torch.models import dinov2 as t_dinov2

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 4, 257, 96, generator=gen).bfloat16().to(cuda)
    b = torch.randn(2, 4, 96, 257, generator=gen).bfloat16().to(cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = t_dinov2._matmul_f32(a, b)
        want = torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = lambda x, y: ((x.float() - y.float()).pow(2).mean().sqrt()
                        / y.float().pow(2).mean().sqrt()).item()
    assert rel(got, want) < 1e-5
    cfg = t_dinov2.dinov2_tiny_test()
    cpu = t_dinov2.Dinov2Attention(cfg, dtype=torch.bfloat16, device="cpu")
    card = t_dinov2.Dinov2Attention(cfg, dtype=torch.bfloat16, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 17, cfg.hidden_size, generator=gen).bfloat16()
    with torch.no_grad():
        assert rel(card(x.to(cuda)).cpu(), cpu(x)) < 2.0 ** -8


# ------------------------------------------------- token path, AudioLDM

def test_duration_predictor_picks_its_kernels(cuda):
    """The duration predictor in bf16 on the card: a forward launches K1
    once per attention (per layer the audio self-attention, the audio
    cross-attention run as self-attention over its own stream when
    dim_context equals dim, the text and the frames streams'), N1 and N2
    once per norm and gate, and nothing else; ``loss`` with a backward
    launches K3, K4 and K5 as often and no K1, N1 or N2. In float32 (the
    CUDA-core kernels, TF32 off) the card's prediction is within 1e-4
    relative of the CPU's from the same weights."""
    import dataclasses

    from v2ap_torch import config as C
    from v2ap_torch.models.duration import DurationPredictor

    cfg = dataclasses.replace(C.tiny_test().model, dim_context=64,
                              dtype="bfloat16")
    torch.manual_seed(0)
    card = DurationPredictor(cfg, device=cuda)
    cpu = DurationPredictor(dataclasses.replace(cfg, dtype="float32"),
                            device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(6)
    latents = torch.from_numpy(rng.normal(size=(3, 40, cfg.num_channels))
                               .astype(np.float32))
    tokens = torch.tensor([[104, 105, -1], [97, 98, 99], [1, -1, -1]])
    lens = torch.tensor([40, 33, 12])
    per_call = 4 * cfg.depth
    fa.reset_launch_counts()
    with torch.no_grad():
        got = card(latents.to(cuda), tokens.to(cuda), lens.to(cuda))
        torch.cuda.synchronize()
    assert fa.launch_counts == {**dict.fromkeys(fa.launch_counts, 0),
                                "flash_attention_packed": per_call,
                                **_norm_launches(cfg, 1)}
    assert torch.isfinite(got).all()
    card32 = DurationPredictor(dataclasses.replace(cfg, dtype="float32"),
                               device=cuda)
    card32.load_state_dict(card.state_dict())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            got32 = card32(latents.to(cuda), tokens.to(cuda),
                           lens.to(cuda)).cpu()
            want = cpu(latents, tokens, lens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert ((got32 - want).abs() / want.abs()).max().item() < 1e-4
    fa.reset_launch_counts()
    loss = card.loss(latents.to(cuda), tokens.to(cuda), lens.to(cuda),
                     frac=torch.tensor([0.9, 0.5, 0.99]))
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launch_counts == {**dict.fromkeys(fa.launch_counts, 0),
                                "flash_attention_lse": per_call,
                                "flash_attention_bwd_dq": per_call,
                                "flash_attention_bwd_dkv": per_call}


def test_audioldm_path_launches_no_flash_kernel(cuda):
    """The AudioLDM backend on the card (tiny configs, float32, TF32 off)
    runs its attention as plain products: no flash wrapper counts; its
    waveform is within 1e-4 relative RMS of the CPU's from the same weights
    and x_t."""
    from v2ap_torch.models import audioldm_vae, clap, hifigan
    from v2ap_torch.models import latent_diffusion as ldm

    a_cfg, t_cfg = clap.clap_tiny_test()
    cfg = ldm.LDMConfig(in_channels=2, out_channels=2, model_channels=16,
                        num_res_blocks=1, attention_resolutions=(2,),
                        channel_mult=(1, 2), num_head_channels=8,
                        film_dim=a_cfg.projection_dim, timesteps=20,
                        latent_t=8, latent_f=4)

    def backend(device):
        torch.manual_seed(0)
        return ldm.AudioLDMBackend(
            cfg, clap=clap.ClapModel(a_cfg, t_cfg, device=device),
            vae=audioldm_vae.AudioLDMVAE(audioldm_vae.AudioLDMVAEConfig(
                mel_bins=8, base_channels=8, channel_mults=(1, 2),
                num_res_blocks=1, latent_channels=2, groups=4),
                device=device),
            vocoder=hifigan.HiFiGANGenerator(hifigan.HiFiGANConfig(
                in_channels=8, upsample_initial_channel=32,
                upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),)),
                device=device), device=device)

    cpu = backend("cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            if not p.abs().sum():
                p.normal_(std=0.05)
    card = backend(cuda)
    card.load_state_dict(cpu.state_dict())
    ids = torch.tensor([[0, 5, 9, 2]])
    mask = torch.ones_like(ids)
    u_ids = torch.tensor([[0, 2, 1, 1]])
    u_mask = torch.tensor([[1, 1, 0, 0]])
    x_t = torch.randn(cpu.latent_shape(1),
                      generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fa.reset_launch_counts()
        got = card.text_to_audio(ids.to(cuda), mask.to(cuda), u_ids.to(cuda),
                                 u_mask.to(cuda), steps=4, x_t=x_t.to(cuda))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    assert fa.launch_counts == dict.fromkeys(fa.launch_counts, 0)
    want = cpu.text_to_audio(ids, mask, u_ids, u_mask, steps=4, x_t=x_t)
    rel = ((got.cpu() - want).pow(2).mean().sqrt()
           / want.pow(2).mean().sqrt()).item()
    assert rel < 1e-4
