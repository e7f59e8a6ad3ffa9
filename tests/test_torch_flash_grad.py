"""Parity of the port's attention gradient (``_FlashAttentionFn``: K3's
forward with lse, K4's and K5's backward) with the JAX package's, on the
CPU in float32, where the port runs the kernels' plain versions
(``attention_fwd_lse_reference``, ``attention_bwd_reference``).

The JAX side runs its Pallas kernels in interpret mode with 128-blocks, as
``tests/test_ops.py`` does, or ``jax.vjp`` of ``attention_reference`` at
lengths the Pallas kernels cannot take. Tolerance rtol = atol = 5e-4, the
one the JAX package holds its own backward kernels to; lse atol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ops import N, T
from v2ap_torch.ops import flash_attention as t_fa

j_fa = importlib.import_module("v2ap_tpu.ops.flash_attention")

torch.set_num_threads(2)

TOL = dict(rtol=5e-4, atol=5e-4)


def _port_grads(fn, inputs, weight):
    """Gradients of sum(fn(*inputs) * weight) on the port's CPU path."""
    ts = [T(a).requires_grad_(True) for a in inputs]
    before = dict(t_fa.launch_counts)
    (fn(*ts) * T(weight)).sum().backward()
    assert t_fa.launch_counts == before       # CPU tensors: plain versions
    return [N(t.grad) for t in ts]


def _packed_case(rng, b, n, h, d, mask):
    q, k, v, w = (rng.normal(size=(b, n, h * d)).astype(np.float32)
                  for _ in range(4))
    return q, k, v, w, mask


@pytest.mark.parametrize("kind", ["random_mask", "fully_masked_element"])
def test_packed_gradients_match_pallas_interpret(kind):
    """flash_attention_packed's gradients at (2, 256, 4x64), softclamp 50,
    against jax.grad through the Pallas packed kernels. With batch element
    1 fully masked both give it exactly zero gradient (Pallas semantics)."""
    rng = np.random.default_rng(0)
    b, n, h, d = 2, 256, 4, 64
    mask = rng.random((b, n)) > 0.3
    if kind == "fully_masked_element":
        mask[1] = False
    q, k, v, w, mask = _packed_case(rng, b, n, h, d, mask)

    def loss_j(q, k, v):
        out = j_fa.flash_attention_packed(
            q, k, v, jnp.asarray(mask), heads=h, dim_head=d, softclamp=50.0,
            block_q=128, block_k=128, interpret=True)
        return (out * w).sum()

    ref = jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)
    got = _port_grads(lambda q, k, v: t_fa.flash_attention_packed(
        q, k, v, T(mask), heads=h, dim_head=d, softclamp=50.0), (q, k, v), w)
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
        if kind == "fully_masked_element":
            np.testing.assert_array_equal(g[1], 0.0)


@pytest.mark.parametrize("kind", ["random_mask", "fully_masked_element"])
def test_4d_gradients_match_pallas_interpret(kind):
    """flash_attention's gradients at (1, 2, 256, 64) (a second batch
    element for the fully masked case), softclamp 50, against jax.grad
    through the Pallas 4D kernels."""
    rng = np.random.default_rng(1)
    b = 1 if kind == "random_mask" else 2
    h, n, d = 2, 256, 64
    q, k, v, w = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                  for _ in range(4))
    mask = rng.random((b, n)) > 0.3
    if kind == "fully_masked_element":
        mask[1] = False

    def loss_j(q, k, v):
        out = j_fa.flash_attention(q, k, v, jnp.asarray(mask), softclamp=50.0,
                                   block_q=128, block_k=128, interpret=True)
        return (out * w).sum()

    ref = jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)
    got = _port_grads(lambda q, k, v: t_fa.flash_attention(
        q, k, v, T(mask), softclamp=50.0), (q, k, v), w)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
        if kind == "fully_masked_element":
            np.testing.assert_array_equal(g[1], 0.0)


@pytest.mark.parametrize("softclamp", [50.0, None])
def test_lse_matches_pallas_interpret(softclamp):
    """K3's second output, the per-row log-sum-exp, against
    ``_flash_fwd_lse_impl`` in interpret mode (one row fully masked, where
    both store ~-1e30); the output against its first output."""
    rng = np.random.default_rng(2)
    b, h, n, d = 2, 2, 256, 64
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((b, n)) > 0.3
    mask[1] = False
    out_j, lse_j = j_fa._flash_fwd_lse_impl(
        q, k, v, jnp.asarray(mask, jnp.int32), softclamp, d ** -0.5, 128,
        128, True)
    out, lse = t_fa.attention_fwd_lse_reference(T(q), T(k), T(v), T(mask),
                                                softclamp=softclamp)
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(N(lse), np.asarray(lse_j)[..., 0], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(N(out), np.asarray(out_j), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("softclamp", [50.0, None])
def test_ragged_gradients_match_reference_vjp(softclamp):
    """At lengths no Pallas kernel takes (nq 200, nk 37; ragged key mask,
    no row fully masked) the port's gradients equal jax.vjp of
    attention_reference, with logits in softclamp's range (std ~8)."""
    rng = np.random.default_rng(3)
    b, h, nq, nk, d = 2, 3, 200, 37, 64
    q = (rng.normal(size=(b, h, nq, d)) * 8.0).astype(np.float32)
    k, v = (rng.normal(size=(b, h, nk, d)).astype(np.float32)
            for _ in range(2))
    w = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    mask = np.arange(nk)[None, :] < np.array([[nk], [20]])
    _, vjp = jax.vjp(lambda q, k, v: j_fa.attention_reference(
        q, k, v, jnp.asarray(mask), softclamp=softclamp), q, k, v)
    ref = vjp(jnp.asarray(w))
    got = _port_grads(lambda q, k, v: t_fa.flash_attention(
        q, k, v, T(mask), softclamp=softclamp), (q, k, v), w)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)


def test_no_grad_keeps_the_serving_forward():
    """Without autograd the entry points take the forward alone (K1/K2 on a
    card): the output equals the autograd path's, which saves lse."""
    rng = np.random.default_rng(4)
    q, k, v = (T(rng.normal(size=(2, 40, 2 * 64))) for _ in range(3))
    mask = T(np.arange(40)[None, :].repeat(2, 0) < 33)
    with torch.no_grad():
        plain = t_fa.flash_attention_packed(q, k, v, mask, heads=2,
                                            dim_head=64, softclamp=50.0)
    q.requires_grad_(True)
    graded = t_fa.flash_attention_packed(q, k, v, mask, heads=2, dim_head=64,
                                         softclamp=50.0)
    assert plain.grad_fn is None and graded.grad_fn is not None
    np.testing.assert_allclose(N(graded), N(plain), rtol=1e-6, atol=1e-6)
