"""The port's T5 encoder (``v2ap_torch/models/t5.py``) against the JAX
package's (``v2ap_tpu/models/t5.py``) on the CPU in float32, with the JAX
model's randomised weights carried across by ``load_jax_params``.

Tolerances: the relative-position buckets are integers and must be equal;
the encoder's hidden states within 1e-4 relative RMS (two layers of f32
matmuls in another summation order), padded rows exactly 0. The T5 configs
are compared field by field in ``test_torch_models.test_config_matches_jax``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch.models import t5 as t_t5
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu.models import t5 as j_t5

torch.set_num_threads(2)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64)])
def test_relative_position_bucket_matches_jax(num_buckets, max_distance):
    rel = np.arange(-300, 301, dtype=np.int64)
    want = j_t5.relative_position_bucket(rel, num_buckets, max_distance)
    got = t_t5.relative_position_bucket(rel, num_buckets, max_distance)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    n = 70                                  # the 2D table an encoder builds
    pos = np.arange(n)
    np.testing.assert_array_equal(
        t_t5.relative_position_bucket(pos[None] - pos[:, None], num_buckets,
                                      max_distance),
        j_t5.relative_position_bucket(pos[None] - pos[:, None], num_buckets,
                                      max_distance))


@pytest.mark.parametrize("gated", [True, False], ids=["gated_gelu", "relu"])
def test_t5_encoder_matches_jax(gated):
    cfg_j = dataclasses.replace(j_t5.t5_tiny_test(), gated_act=gated)
    cfg_t = dataclasses.replace(t_t5.t5_tiny_test(), gated_act=gated)
    jm = j_t5.T5Encoder(cfg_j, rngs=nnx.Rngs(0))
    randomize_jax(jm, 3, scale=0.3)
    tm = t_t5.T5Encoder(cfg_t, device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    rng = np.random.default_rng(1)
    b, n = 3, 40                            # relative distances past 8
    ids = rng.integers(0, cfg_j.vocab_size, (b, n)).astype(np.int32)
    lens = np.array([40, 11, 1])
    mask = (np.arange(n)[None] < lens[:, None]).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = N(tm(T(ids).long(), T(mask).bool()))
    assert got.shape == want.shape == (b, n, cfg_j.d_model)
    assert rel_rms(got, want) < 1e-4
    pad = mask == 0
    assert not got[pad].any() and not want[pad].any()
    # without a mask every row is valid
    want = np.asarray(jm(jnp.asarray(ids[:1, :9])))
    with torch.no_grad():
        got = N(tm(T(ids[:1, :9]).long()))
    assert rel_rms(got, want) < 1e-4
