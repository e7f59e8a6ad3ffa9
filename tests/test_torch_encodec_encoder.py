"""Parity of the port's EnCodec encoder and residual vector quantizer
(``v2ap_torch.models.encodec``) with the JAX package's, on the CPU in
float32, the JAX model's weights carried across by ``load_jax_params``.

Tolerances: latents 1e-5 relative RMS (strided causal convolutions and the
LSTM scan in another summation order); the quantizer's codes equal, and
decoding the codes exact to 1e-6 (a sum of the same codebook rows).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch.models import encodec as t_encodec
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu.models import encodec as j_encodec

torch.set_num_threads(2)

LATENT_REL_RMS = 1e-5
TINY = dict(hidden_size=8, num_filters=4, num_lstm_layers=1,
            codebook_size=64, num_quantizers=6)


def _pair(full: bool, seed: int):
    kw = {} if full else TINY
    jcfg = dataclasses.replace(j_encodec.EncodecConfig(), **kw)
    jm = j_encodec.EncodecModel(jcfg, rngs=nnx.Rngs(seed))
    if not full:               # LSTM and conv weights of a trained scale
        randomize_jax(jm, seed, scale=0.3)
    tm = t_encodec.EncodecModel(
        dataclasses.replace(t_encodec.EncodecConfig(), **kw), device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.fixture(scope="module", params=["tiny", "full"])
def encoded(request):
    """Both codecs' latents of the same waveforms: (2, 0.5 s) at the full
    24 kHz config, (3, 4321 samples: a ragged hop) at a tiny one."""
    full = request.param == "full"
    jm, tm = _pair(full, 3)
    shape = (2, 12_000) if full else (3, 4321)
    wav = (np.random.default_rng(5).normal(size=shape) * 0.3).astype(
        np.float32)
    want = np.asarray(nnx.jit(lambda m, w: m.encode(w))(jm, wav))
    with torch.no_grad():
        got = N(tm.encode(T(wav)))
    return jm, tm, wav, got, want


def test_encode_matches_jax(encoded):
    """One latent per started 320-sample hop, 128 (or the tiny width)
    channels."""
    _, tm, wav, got, want = encoded
    assert got.shape == want.shape == (
        wav.shape[0], -(-wav.shape[1] // 320), tm.cfg.hidden_size)
    assert rel_rms(got, want) < LATENT_REL_RMS


def test_encode_takes_a_channel_axis(encoded):
    """(b, t, 1) waveforms give what (b, t) give, as in JAX."""
    _, tm, wav, got, _ = encoded
    with torch.no_grad():
        np.testing.assert_array_equal(N(tm.encode(T(wav)[..., None])), got)


def test_rvq_codes_and_decode_match_jax(encoded):
    """The quantizer on the JAX latents: equal codes for every codebook,
    and the codes decoded back to the same latents."""
    jm, tm, _, _, want = encoded
    nq = tm.cfg.num_quantizers
    codes_j = np.asarray(nnx.jit(
        lambda m, z: m.quantizer.encode(z, nq))(jm, want))
    with torch.no_grad():
        codes_t = tm.quantizer.encode(T(want), nq)
        dec_t = N(tm.quantizer.decode(codes_t))
    np.testing.assert_array_equal(N(codes_t), codes_j)
    assert codes_j.shape == (nq,) + want.shape[:2]
    dec_j = np.asarray(nnx.jit(lambda m, c: m.quantizer.decode(c))(
        jm, jax.numpy.asarray(codes_j)))
    np.testing.assert_allclose(dec_t, dec_j, atol=1e-6, rtol=0)
