"""The port's Video2Roll net and ``CFM.encode_frames`` (``v2ap_torch/
models/video2roll.py``, ``models/cfm.py``) against the JAX package's on the
CPU in float32, at the real 5 x 100 x 900 keyboard-strip input.

Weights: every JAX parameter is redrawn from a seed (kernels at He scale so
the 20-odd layers neither vanish nor blow up), and so are BatchNorm's
running mean and variance (var > 0), which ``randomize_jax`` leaves at 0 and
1; ``load_jax_params`` carries them across (NHWC conv kernels to NCHW,
BatchNorm statistics to buffers).

Tolerance: logits and roll probabilities within 1e-4 relative RMS (f32
convolutions in another summation order); the structure of the roll (the
x3 repeat, the zero tail) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax
from v2ap_torch import config as t_config
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.models import video2roll as t_v2r
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.models import video2roll as j_v2r

torch.set_num_threads(2)

REL_RMS = 1e-4


def randomize_params_and_stats(model, seed: int) -> None:
    """Redraw every parameter and BatchNorm statistic of a JAX model:
    kernels normal at He scale (fan-in = all but the last axis), 1D
    parameters 1 + 0.1 N (BatchNorm scales) or 0.1 N (biases), running means
    0.1 N, running variances uniform in [0.5, 2]."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = str(path[-1].key if hasattr(path[-1], "key") else path[-1])
        shape = x.shape
        if name == "var":
            value = rng.uniform(0.5, 2.0, shape)
        elif name == "mean" or name == "bias":
            value = rng.normal(size=shape) * 0.1
        elif len(shape) >= 2:
            value = rng.normal(size=shape) * np.sqrt(
                2.0 / np.prod(shape[:-1]))
        else:
            value = 1.0 + rng.normal(size=shape) * 0.1
        return jnp.asarray(value, x.dtype)

    for kind in (nnx.Param, nnx.BatchStat):
        state = nnx.state(model, kind)
        nnx.update(model, jax.tree_util.tree_map_with_path(draw, state))


def test_video2roll_matches_jax():
    """Two windows of 5 strips: logits of the whole net, the BatchNorm path
    with non-trivial statistics included."""
    jm = j_v2r.Video2RollNet(num_classes=51, rngs=nnx.Rngs(0))
    randomize_params_and_stats(jm, 1)
    flat = flatten_jax(jm)
    assert np.asarray(flat["stem.bn.var"]).min() >= 0.5
    tm = t_v2r.Video2RollNet(num_classes=51, device="cpu")
    load_jax_params(tm, flat)
    assert tm.stem.bn.running_var.min() >= 0.5
    x = np.random.default_rng(2).random((2, 5, 100, 900)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = N(tm(T(x)))
    assert got.shape == want.shape == (2, 51)
    assert rel_rms(got, want) < REL_RMS


def _cfm_pair(cfg_j, cfg_t, seed):
    """A tiny JAX CFM with Video2Roll (all parameters and BatchNorm
    statistics randomised) and its port."""
    shrink = dict(dim=64, depth=2, heads=2, dim_head=32, dim_text=48,
                  text_heads=2, text_dim_head=32, text_depth=2, dim_frames=32,
                  frames_heads=2, frames_dim_head=16, max_seq_len=128,
                  kernel_size=7, num_registers=4, num_channels=16,
                  dim_context=32, dtype="float32")
    mj = dataclasses.replace(cfg_j.model, **shrink)
    mt = dataclasses.replace(cfg_t.model, **shrink)
    jm = j_cfm.CFM(mj, cfg_j.conditioning, with_video2roll=True,
                   rngs=nnx.Rngs(seed))
    randomize_params_and_stats(jm, seed + 1)
    tm = t_cfm.CFM(mt, cfg_t.conditioning, with_video2roll=True, device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.mark.parametrize("variant,length,rows", [
    ("v2a_default", 16, 12), ("v2p_88key", 12, 10)],
    ids=["notes51_x3", "notes88_x2.5"])
def test_encode_frames_matches_jax(variant, length, rows):
    """4 strips -> 4 edge-clamped windows -> sigmoid -> x3 (51 keys) or
    x2.5 (88 keys: x5, then pair means) -> zero pad to ``length``."""
    jm, tm = _cfm_pair(getattr(j_config, variant)(),
                       getattr(t_config, variant)(), 3)
    notes = tm.cfg.notes
    frames = np.random.default_rng(4).random((1, 4, 100, 900)
                                             ).astype(np.float32)
    want = np.asarray(nnx.jit(lambda m, f: m.encode_frames(f, length))(
        jm, jnp.asarray(frames)))
    with torch.no_grad():
        got = N(tm.encode_frames(T(frames), length))
    assert got.shape == want.shape == (1, length, notes)
    assert got.dtype == np.float32
    assert rel_rms(got, want) < REL_RMS
    assert not got[0, rows:].any() and np.abs(got[0, :rows]).sum() > 0
    assert 0.0 <= got.min() and got.max() <= 1.0
    if notes == 51:                        # each window's row repeats x3
        np.testing.assert_array_equal(got[0, 0], got[0, 2])
        np.testing.assert_array_equal(got[0, 9], got[0, 11])
    # a trim: fewer rows than the windows give
    with torch.no_grad():
        short = N(tm.encode_frames(T(frames), 5))
    np.testing.assert_array_equal(short, got[:, :5])


def test_encode_frames_needs_the_net():
    with pytest.raises(ValueError, match="without Video2Roll"):
        t_cfm.CFM(t_config.tiny_test().model, device="cpu").encode_frames(
            torch.zeros(1, 2, 100, 900), 6)
