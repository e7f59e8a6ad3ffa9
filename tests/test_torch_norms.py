"""The fused norm wrappers of ``v2ap_torch/ops/norms.py`` on the CPU: the
plain path the CPU and autograd take, the two-rounding formula the gated
residual kernel (N2) computes, the checks the kernels' wrappers make before
a launch, and the launch counters. The kernels themselves run in
``tests/test_torch_cuda.py``."""

import pytest
import torch

from v2ap_torch.ops import flash_attention as fa
from v2ap_torch.ops import norms

DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


def _x(dtype, b=2, n=9, d=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, n, d, generator=gen) * 3).to(dtype)
    x[0, 0] = 0                            # the eps floor
    return x, torch.randn(b, d, generator=gen)


@pytest.mark.parametrize("dtype", DTYPES)
def test_modules_on_the_cpu_equal_the_composites(dtype):
    """RMSNorm, AdaptiveRMSNorm (gamma given or projected) and the gated
    residual on CPU tensors give the composites' bits, with and without
    autograd, and launch nothing."""
    x, gamma = _x(dtype)
    d = x.shape[-1]
    torch.manual_seed(0)
    norm = norms.RMSNorm(d)
    adaptive = norms.AdaptiveRMSNorm(d)
    gate = norms.AdaLNZero(d)
    with torch.no_grad():
        norm.g.normal_()
        adaptive.to_gamma.weight.normal_()
    cond = torch.randn(2, d)

    def l2(t):
        t = t.float()
        return t / torch.sqrt(torch.clamp((t * t).sum(-1, keepdim=True),
                                          min=1e-24))

    scale = float(d) ** 0.5
    before = dict(fa.launch_counts)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            assert torch.equal(norm(x), (l2(x) * scale * norm.g).to(dtype))
            assert torch.equal(
                adaptive(x, gamma=gamma),
                (l2(x) * scale * (gamma[:, None] + 1.0)).to(dtype))
            projected = adaptive.to_gamma(cond)[:, None]
            assert torch.equal(
                adaptive(x, condition=cond),
                (l2(x) * scale * (projected + 1.0)).to(dtype))
            gated = (x.float() * torch.sigmoid(gamma[:, None])).to(dtype)
            assert torch.equal(gate.residual(x, x.flip(1), gamma=gamma),
                               x + (x.flip(1).float() * torch.sigmoid(
                                   gamma[:, None])).to(dtype))
            assert torch.equal(gate(x, gamma=gamma), gated)
    assert fa.launch_counts == before


@pytest.mark.parametrize("seed", range(3))
def test_two_rounding_formula_is_the_gated_residual(seed):
    """N2's formula, bf16(f32(x) + f32(bf16(f32(branch) * sigmoid(gamma)))),
    equals ``x + AdaLNZero(branch)`` bit for bit in bf16, on values spread
    over many binades."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(3, 64, 128, generator=gen)
         * torch.exp2(torch.randint(-8, 8, (3, 64, 1), generator=gen))
         ).to(torch.bfloat16)
    branch = (torch.randn(3, 64, 128, generator=gen) * 16).to(torch.bfloat16)
    gamma = torch.randn(3, 128, generator=gen) * 4
    gate = norms.AdaLNZero(128)
    s = 1.0 / (1.0 + torch.exp(-gamma))[:, None]
    formula = (x.float() + (branch.float() * s).to(torch.bfloat16).float()
               ).to(torch.bfloat16)
    assert torch.equal(formula, x + gate(branch, gamma=gamma))
    assert torch.equal(formula, gate.residual(x, branch, gamma=gamma))


def test_wrapper_checks_before_a_launch():
    """What the kernels' wrappers accept and refuse, checked on CPU tensors
    (the checks read only shapes, strides and addresses): the served views
    pass; rows other than (b, n, d), a width off the multiple of 8, a third
    dtype, a misaligned view, a per-token gamma and a gamma of another
    batch are refused."""
    x = torch.zeros(2, 832, 1024, dtype=torch.bfloat16)
    norms._check_rows(x[:, 32:], "x")
    fused = torch.zeros(2, 12, 6, 1024).permute(1, 0, 2, 3)
    slot = norms._batch_gain(fused[5][:, 2], x)
    assert slot.shape == (2, 1024) and slot.stride(0) == 6 * 1024 * 12
    assert norms._batch_gain(torch.zeros(2, 1, 1024), x).stride(0) == 1024
    with pytest.raises(ValueError, match=r"\(b, n, d\)"):
        norms._check_rows(x[0], "x")
    with pytest.raises(ValueError, match="multiple of 8"):
        norms._check_rows(torch.zeros(2, 4, 20), "x")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norms._check_rows(torch.zeros(2, 4, 16, dtype=torch.float16),
                          "x")
    with pytest.raises(ValueError, match="16-byte"):
        norms._check_rows(
            torch.zeros(2, 4, 17, dtype=torch.bfloat16)[..., 1:], "x")
    with pytest.raises(ValueError, match="16-byte"):
        norms._check_rows(
            torch.zeros(2, 4, 12, dtype=torch.bfloat16)[..., :8], "x")
    with pytest.raises(ValueError, match="per-batch-row"):
        norms._batch_gain(torch.zeros(2, 832, 1024), x)
    for other in (torch.zeros(3, 1024), torch.zeros(1, 1024)):
        with pytest.raises(ValueError, match="per-batch-row"):
            norms._batch_gain(other, x)


def test_launch_counters_have_the_norm_kernels():
    """N1 and N2 count in the port's launch registry, where a graph's
    replays add what its capture recorded, and reset with it."""
    assert {"rms_norm", "gated_residual"} <= set(fa.launch_counts)
    before = dict(fa.launch_counts)
    fa.add_launches({"rms_norm": 85, "gated_residual": 36})
    assert fa.launch_counts == {**before,
                                "rms_norm": before["rms_norm"] + 85,
                                "gated_residual": before["gated_residual"]
                                + 36}
    fa.reset_launch_counts()
    assert fa.launch_counts == dict.fromkeys(before, 0)
