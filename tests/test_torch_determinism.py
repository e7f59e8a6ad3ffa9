"""``v2ap_torch.utils.determinism`` against the JAX package's: the same
verdicts and messages on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2ap_torch.utils import determinism as t_det
from v2ap_tpu.utils import determinism as j_det


def test_assert_deterministic_over_nested_outputs():
    x = torch.arange(6.0).reshape(2, 3)
    t_det.assert_deterministic(lambda a: {"y": [a * 2, (a + 1,)]}, x,
                               runs=3)
    calls = [0]

    def drifting(a):
        calls[0] += 1
        return {"y": a + calls[0] * 0.25}

    with pytest.raises(AssertionError, match=r"run 1: max \|delta\|=0\.25"):
        t_det.assert_deterministic(drifting, x)
    jcalls = [0]

    def jax_drifting(a):
        jcalls[0] += 1
        return {"y": jnp.asarray(a) + jcalls[0] * 0.25}

    with pytest.raises(AssertionError, match=r"run 1: max \|delta\|=0\.25"):
        j_det.assert_deterministic(jax_drifting, np.arange(6.0))
    # NaNs compare equal, bf16 leaves are read
    t_det.assert_deterministic(
        lambda: (torch.tensor([float("nan"), 1.0]),
                 torch.ones(2, dtype=torch.bfloat16)))


def test_debug_nans_names_the_op_forward_and_backward():
    a = torch.tensor([1.0, -1.0], requires_grad=True)
    with t_det.debug_nans():
        y = torch.exp(a)                         # finite: no trap
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(a)
    b = torch.tensor([0.0], requires_grad=True)
    out = (b * torch.tensor([float("inf")])).sum()
    with t_det.debug_nans():
        with pytest.raises(FloatingPointError, match="mul"):
            out.backward(torch.tensor(0.0))      # 0 * inf in the backward
    with t_det.debug_nans(False):
        torch.sqrt(a)
    assert torch.isfinite(y).all()


def test_tree_finite_report_matches_jax():
    tree = {"a": np.ones(3, np.float32),
            "b": [np.array([1.0, np.nan]), np.arange(3)],
            "c": {"d": np.array([np.inf], np.float32)}}
    want = j_det.tree_finite_report(tree, prefix="p")
    got = t_det.tree_finite_report(
        {k: v for k, v in tree.items()}, prefix="p")
    assert got == want == ["p['b'][0]", "p['c']['d']"]
    tt = {"a": torch.ones(2), "b": [torch.tensor([float("nan")]),
                                    torch.arange(2)]}
    assert t_det.tree_finite_report(tt) == ["['b'][0]"]
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.bias[0] = float("inf")
    assert t_det.tree_finite_report(lin, prefix="m") == ["m['bias']"]
