"""The port of the packed-layout probe (``v2ap_torch/scripts/
probe_flash_bnhd.py``) against the JAX script's Pallas kernel P1
(``scripts/probe_flash_bnhd.py``, ``flash_bnhd``) run in interpret mode on
the CPU, in float32.

The JAX script's ``flash_bnhd`` has no ``interpret`` argument, so the test
loads the script with importlib and swaps the loaded module's ``pl`` for a
namespace whose ``pallas_call`` runs in interpret mode; the script itself is
unchanged. Tolerance: max abs 1e-5 (both sides f32, summation order only).
"""

import functools
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tests.test_torch_ops import N, T
from v2ap_torch.scripts import probe_flash_bnhd as t_probe
from v2ap_tpu.ops.rope import apply_rope as j_apply_rope

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
B, NSEQ, H, D = 2, 64, 4, 16


@pytest.fixture(scope="module")
def j_probe():
    spec = importlib.util.spec_from_file_location(
        "_jax_probe_flash_bnhd", ROOT / "scripts" / "probe_flash_bnhd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, ds=pl.ds)
    return mod


def _mask(kind: str) -> np.ndarray:
    mask = np.ones((B, NSEQ), bool)
    if kind == "ragged":
        mask[0, 50:] = False
        mask[1, 23:] = False
    elif kind == "all_masked":            # batch element 1 attends nothing
        mask[1] = False
    return mask


@pytest.mark.parametrize("softclamp,mask_kind,gain", [
    (50.0, "all_masked", 1.0), (50.0, "ragged", 40.0), (None, "ragged", 1.0),
    (None, "ones", 1.0)],
    ids=["softclamp_fully_masked", "softclamp_std40_ragged",
         "no_softclamp_ragged", "no_softclamp_no_mask"])
def test_flash_bnhd_matches_pallas_p1(j_probe, softclamp, mask_kind, gain):
    """The port's P1 (plain version on the CPU) against the Pallas P1 on
    the same packed inputs, at blocks of 32 (two q and two k blocks)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, NSEQ, H * D)).astype(np.float32)
               for _ in range(3))
    q *= gain                               # std-40 logits: tanh bends
    mask = _mask(mask_kind)
    kv = None if mask_kind == "ones" else mask
    want = j_probe.flash_bnhd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if kv is None else jnp.asarray(kv), softclamp=softclamp,
        block_q=32, block_k=32, heads=H, dim_head=D)
    got = t_probe.flash_bnhd(T(q), T(k), T(v),
                             None if kv is None else T(kv),
                             softclamp=softclamp, heads=H, dim_head=D)
    assert got.shape == (B, NSEQ, H * D) and got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), atol=ATOL, rtol=0)
    if mask_kind == "all_masked":
        # a row that attends nothing averages v over every key, as P1 does
        np.testing.assert_allclose(N(got)[1], np.broadcast_to(
            v[1].mean(0), (NSEQ, H * D)), atol=ATOL)


def test_probe_paths_match_pallas_p1(j_probe):
    """Both of the port's probe paths, from the probe's own seeded inputs
    in f32, against the JAX script's new path (rotary with seq_axis=1, then
    the Pallas P1 in interpret mode)."""
    qkv, mask, rot = t_probe.probe_inputs(B, NSEQ, H, D, "cpu",
                                          dtype=torch.float32)
    old_path, new_path = t_probe.make_paths(B, NSEQ, H, D, rot, mask)
    jqkv, jrot = jnp.asarray(N(qkv)), jnp.asarray(N(rot))
    q, k, v = jnp.split(jqkv, 3, axis=-1)
    sp = lambda t: t.reshape(B, NSEQ, H, D)
    q = j_apply_rope(sp(q), jrot, seq_axis=1).reshape(B, NSEQ, H * D)
    k = j_apply_rope(sp(k), jrot, seq_axis=1).reshape(B, NSEQ, H * D)
    want = np.asarray(j_probe.flash_bnhd(
        q, k, v, jnp.asarray(N(mask)), softclamp=50.0, block_q=32,
        block_k=32, heads=H, dim_head=D))
    for path in (old_path, new_path):
        np.testing.assert_allclose(N(path(qkv)), want, atol=ATOL, rtol=0)


def test_probe_main_runs_on_cpu(capsys):
    """The command line end to end on the plain versions: both paths agree
    and each is timed."""
    out = t_probe.main(["--batch", "2", "--seq", "32", "--heads", "2",
                        "--dim-head", "16", "--reps", "2", "--device", "cpu"])
    assert out["rel_rms"] < 1e-2 and out["old_ms"] > 0 and out["new_ms"] > 0
    assert "parity old vs new rel-rms" in capsys.readouterr().out


def test_flash_bnhd_refuses_a_bad_width():
    x = torch.zeros(1, 4, 48)
    with pytest.raises(ValueError, match="packed width"):
        t_probe.flash_bnhd(x, x, x, heads=2, dim_head=16)
