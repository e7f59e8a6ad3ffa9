"""Parity of the PyTorch port's operators (``v2ap_torch.ops``) with the JAX
package's (``v2ap_tpu.ops``), on the CPU in float32.

Inputs come from numpy with a fixed seed and go through both functions;
weights go JAX -> port through ``load_jax_params``. Unless a test says
otherwise the tolerance is atol = rtol = 1e-5: both sides compute in f32
and differ only in summation order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from v2ap_torch.ops import attention as t_attention
from v2ap_torch.ops import conv as t_conv
from v2ap_torch.ops import feedforward as t_ff
from v2ap_torch.ops import flash_attention as t_fa
from v2ap_torch.ops import fourier as t_fourier
from v2ap_torch.ops import norms as t_norms
from v2ap_torch.ops import rope as t_rope
from v2ap_torch.ops import sampling as t_sampling
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu.ops import attention as j_attention
from v2ap_tpu.ops import conv as j_conv
from v2ap_tpu.ops import feedforward as j_ff
from v2ap_tpu.ops import fourier as j_fourier
from v2ap_tpu.ops import norms as j_norms
from v2ap_tpu.ops import rope as j_rope
from v2ap_tpu.ops import sampling as j_sampling

# v2ap_tpu.ops re-exports a function named flash_attention over the module
j_fa = importlib.import_module("v2ap_tpu.ops.flash_attention")

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _no_shared_compile_cache():
    """Compile this module's JAX references in this process only.

    ``tests/conftest.py`` points every pytest-xdist worker at one persistent
    compilation cache directory, and JAX writes an entry there in place (an
    existence check, then ``write_bytes``, with no lock while eviction is
    off): under load a worker can read an executable that another worker is
    still writing. That cache is the one state this module shares with the
    other workers, and its first JAX compile,
    ``test_attention_reference_matches_jax[ragged_800_like]``, failed in a
    full parallel run while passing alone and in a run of the port's tests.
    The cache is turned off for this module and back on after it; nothing
    else changes."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    cc.reset_cache()


def T(a) -> torch.Tensor:
    """numpy / jax array -> torch tensor (float32 unless integer / bool)."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f"
                            else a.copy())


def N(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def flatten_jax(model) -> dict:
    """A JAX module's parameters and fixed buffers as {dotted path: array}
    (RNG state left out) — the form ``load_jax_params`` takes."""
    flat = {}
    for path, var in nnx.to_flat_state(nnx.state(model)):
        if isinstance(var, nnx.RngState):
            continue
        flat[".".join(map(str, path))] = np.asarray(var[...])
    return flat


def randomize_jax(model, seed: int, scale: float = 0.1) -> None:
    """Replace every JAX parameter with seeded gaussian values, so that
    zero-initialised projections (AdaLN, stream fusions) are exercised."""
    rng = np.random.default_rng(seed)
    state = nnx.state(model, nnx.Param)
    nnx.update(model, jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape) * scale, x.dtype), state))


def port_weights(jax_model, torch_model):
    load_jax_params(torch_model, flatten_jax(jax_model))
    return torch_model


# --------------------------------------------------------------- attention

def _qkvm(rng, b, h, nq, nk, d, mask_kind):
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "ragged":           # the serving bucket's valid tail
        mask = np.arange(nk)[None, :].repeat(b, 0) < nk - 18
    elif mask_kind == "ones":
        mask = np.ones((b, nk), bool)
    else:                                 # batch row 1 fully masked
        mask = np.ones((b, nk), bool)
        mask[1] = False
    return q, k, v, mask


@pytest.mark.parametrize("case", [
    # (b, h, nq, nk, d, softclamp, mask, scale)
    ("ragged_800_like", (2, 2, 200, 200, 64, 50.0, "ragged", None)),
    ("cross_nk1", (2, 2, 200, 1, 64, 50.0, "ones", None)),
    ("clip_d104", (2, 2, 257, 257, 104, None, "none", 104 ** -0.5)),
    ("fully_masked_row", (2, 2, 130, 130, 64, 50.0, "all_masked", None)),
], ids=lambda c: c[0])
def test_attention_reference_matches_jax(case):
    """The plain version (the CPU path and the kernel's oracle) against the
    JAX package's attention_reference at lengths the Pallas kernels cannot
    take (ragged, nk = 1, d = 104) and with a fully masked row."""
    b, h, nq, nk, d, softclamp, mask_kind, scale = case[1]
    q, k, v, mask = _qkvm(np.random.default_rng(0), b, h, nq, nk, d, mask_kind)
    ref = j_fa.attention_reference(q, k, v, None if mask is None else
                                   jnp.asarray(mask), softclamp=softclamp,
                                   scale=scale)
    out = t_fa.attention_reference(T(q), T(k), T(v), None if mask is None
                                   else T(mask), softclamp=softclamp,
                                   scale=scale)
    np.testing.assert_allclose(N(out), np.asarray(ref), **TOL)


def test_flash_attention_matches_pallas_interpret():
    """K2's entry point against the Pallas 4D kernel run in interpret mode.
    Tolerance rtol 2e-4 / atol 2e-5, the one the JAX package's own test
    holds its kernel to against attention_reference."""
    q, k, v, mask = _qkvm(np.random.default_rng(1), 1, 2, 128, 128, 64,
                          "ragged")
    ref = j_fa.flash_attention(q, k, v, jnp.asarray(mask), softclamp=50.0,
                               block_q=128, block_k=128, interpret=True)
    before = dict(t_fa.launch_counts)
    out = t_fa.flash_attention(T(q), T(k), T(v), T(mask), softclamp=50.0)
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=2e-4, atol=2e-5)
    assert t_fa.launch_counts == before      # CPU tensors take the plain path


@pytest.mark.parametrize("h", [4, 2])
def test_flash_packed_matches_pallas_interpret(h):
    """K1's entry point against the Pallas packed kernel in interpret mode
    (same tolerance as above)."""
    rng = np.random.default_rng(2)
    b, n, d = 2, 256, 64
    q, k, v = (rng.normal(size=(b, n, h * d)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((b, n)) > 0.3
    ref = j_fa.flash_attention_packed(q, k, v, jnp.asarray(mask), heads=h,
                                      dim_head=d, softclamp=50.0, block_q=128,
                                      block_k=128, interpret=True)
    out = t_fa.flash_attention_packed(T(q), T(k), T(v), T(mask), heads=h,
                                      dim_head=d, softclamp=50.0)
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


# The CUDA kernel's own tests, which need the card, are in test_torch_cuda.py.


# -------------------------------------------------------------------- rope

def test_rope_table_and_apply_match_jax():
    rng = np.random.default_rng(4)
    tab_j = j_rope.rope_table(40, 32)
    tab_t = t_rope.rope_table(40, 32)
    np.testing.assert_allclose(N(tab_t), np.asarray(tab_j), **TOL)
    x = rng.normal(size=(2, 3, 36, 32)).astype(np.float32)      # (b, h, n, d)
    np.testing.assert_allclose(N(t_rope.apply_rope(T(x), tab_t)),
                               np.asarray(j_rope.apply_rope(x, tab_j)), **TOL)
    # packed (b, n, h, d) layout with seq_axis=1, and partial rotary: a
    # 16-wide table on 32-wide heads leaves the tail unrotated
    xp = rng.normal(size=(2, 36, 3, 32)).astype(np.float32)
    tab16_j, tab16_t = j_rope.rope_table(40, 16), t_rope.rope_table(40, 16)
    np.testing.assert_allclose(
        N(t_rope.apply_rope(T(xp), tab16_t, seq_axis=1)),
        np.asarray(j_rope.apply_rope(xp, tab16_j, seq_axis=1)), **TOL)


# ------------------------------------------------------------------- norms

def test_norms_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    cond = rng.normal(size=(2, 24)).astype(np.float32)
    x[0, 0] = 0.0                         # exercises eps inside the sqrt

    jr = j_norms.RMSNorm(24, rngs=nnx.Rngs(0))
    randomize_jax(jr, 0)
    tr = port_weights(jr, t_norms.RMSNorm(24))
    np.testing.assert_allclose(N(tr(T(x))), np.asarray(jr(x)), **TOL)

    ja = j_norms.AdaptiveRMSNorm(24, rngs=nnx.Rngs(0))
    randomize_jax(ja, 1)
    ta = port_weights(ja, t_norms.AdaptiveRMSNorm(24))
    np.testing.assert_allclose(N(ta(T(x), condition=T(cond))),
                               np.asarray(ja(x, condition=cond)), **TOL)

    jg = j_norms.AdaLNZero(24, rngs=nnx.Rngs(0))
    randomize_jax(jg, 2)
    tg = port_weights(jg, t_norms.AdaLNZero(24))
    np.testing.assert_allclose(N(tg(T(x), condition=T(cond))),
                               np.asarray(jg(x, condition=cond)), **TOL)
    gamma = rng.normal(size=(2, 24)).astype(np.float32)      # precomputed
    np.testing.assert_allclose(N(tg(T(x), gamma=T(gamma))),
                               np.asarray(jg(x, gamma=gamma)), **TOL)
    np.testing.assert_allclose(N(ta(T(x), gamma=T(gamma))),
                               np.asarray(ja(x, gamma=gamma)), **TOL)


def test_adaln_zero_init_matches_jax_defaults():
    """Unloaded, the port's gates start where the JAX ones do: zero
    projection, bias -2 (sigmoid ~0.12)."""
    g = t_norms.AdaLNZero(8)
    x = torch.ones(1, 3, 8)
    out = g(x, condition=torch.randn(1, 8))
    np.testing.assert_allclose(N(out), 1 / (1 + np.exp(2.0)), rtol=1e-6)


# -------------------------------------------------------------- conv / ff

def test_depthwise_conv_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 19, 12)).astype(np.float32)
    mask = np.arange(19)[None, :].repeat(2, 0) < np.array([[19], [11]])
    jc = j_conv.DepthwiseConv1d(12, 7, rngs=nnx.Rngs(0))
    randomize_jax(jc, 3, scale=0.3)
    tc = port_weights(jc, t_conv.DepthwiseConv1d(12, 7))
    np.testing.assert_allclose(N(tc(T(x), mask=T(mask))),
                               np.asarray(jc(x, mask=jnp.asarray(mask))), **TOL)


def test_glu_feedforward_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 5, 16)).astype(np.float32)
    jf = j_ff.GLUFeedForward(16, 4, rngs=nnx.Rngs(0))
    tf = port_weights(jf, t_ff.GLUFeedForward(16, 4))
    np.testing.assert_allclose(N(tf(T(x))), np.asarray(jf(x)), **TOL)


def test_time_cond_mlp_matches_jax():
    times = np.array([0.0, 0.37, 1.0], np.float32)
    jm = j_fourier.TimeCondMLP(32, rngs=nnx.Rngs(0))
    tm = port_weights(jm, t_fourier.TimeCondMLP(32))
    np.testing.assert_allclose(N(tm(T(times))), np.asarray(jm(times)), **TOL)


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("steps,sway", [(25, True), (4, True), (6, False)])
def test_sway_timesteps_identical(steps, sway):
    np.testing.assert_array_equal(t_sampling.sway_timesteps(steps, sway),
                                  j_sampling.sway_timesteps(steps, sway))


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun"])
def test_euler_integrate_matches_scan(method):
    """The Python loop against the JAX scan on a nonlinear field."""
    rng = np.random.default_rng(8)
    y0 = rng.normal(size=(2, 5)).astype(np.float32)
    w = rng.normal(size=(5, 5)).astype(np.float32) * 0.5
    ts = j_sampling.sway_timesteps(9)
    out_j = j_sampling.euler_integrate(
        lambda t, y: jnp.tanh(y @ w) * (1.0 + t), jnp.asarray(y0),
        jnp.asarray(ts), method=method)
    wt = T(w)
    out_t = t_sampling.euler_integrate(
        lambda t, y: torch.tanh(y @ wt) * (1.0 + t), T(y0), ts, method=method)
    np.testing.assert_allclose(N(out_t), np.asarray(out_j), **TOL)


def test_project_parallel_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    y = rng.normal(size=(3, 4, 5)).astype(np.float32)
    y[2] = 0.0                                      # the clamp at 1e-24
    for a, b in zip(t_sampling.project_parallel(T(x), T(y)),
                    j_sampling.project_parallel(x, y)):
        np.testing.assert_allclose(N(a), np.asarray(b), **TOL)


# --------------------------------------------------------- attention module

@pytest.mark.parametrize("kind", ["self_rotary", "cross_context",
                                  "cross_no_context"])
def test_attention_module_matches_jax(kind):
    """Fused-qkv self-attention with rotary and a ragged mask; split
    cross-attention over a context; and cross-attention with no context,
    which degrades to rotary self-attention (the empty-prompt reference
    path). All through K1's entry point on the port side."""
    rng = np.random.default_rng(10)
    b, n, dim, h, d = 2, 37, 48, 3, 16
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    mask = np.arange(n)[None, :].repeat(b, 0) < np.array([[n], [30]])
    rot_j, rot_t = j_rope.rope_table(n + 4, d), t_rope.rope_table(n + 4, d)
    kw = {}
    call_j = dict(mask=jnp.asarray(mask), rotary=rot_j)
    call_t = dict(mask=T(mask), rotary=rot_t)
    if kind != "self_rotary":
        kw = dict(dim_context=dim if kind == "cross_no_context" else 24,
                  cross_attention=True)
    if kind == "cross_context":
        ctx = rng.normal(size=(b, 5, 24)).astype(np.float32)
        cmask = np.ones((b, 5), bool)
        cmask[1, 3:] = False
        call_j.update(context=ctx, context_mask=jnp.asarray(cmask))
        call_t.update(context=T(ctx), context_mask=T(cmask))
    ja = j_attention.Attention(dim, h, d, rngs=nnx.Rngs(0), **kw)
    ta = port_weights(ja, t_attention.Attention(dim, h, d, **kw))
    np.testing.assert_allclose(N(ta(T(x), **call_t)),
                               np.asarray(ja(x, **call_j)), **TOL)
