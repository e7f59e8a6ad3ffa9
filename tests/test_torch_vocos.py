"""The port's Vocos vocoder against the JAX package's, on the CPU in
float32: ``istft`` (against JAX's and against the loop-and-scatter
overlap-add of ``tests/test_vocos.py``), ``Vocos.decode`` at
``vocos_tiny_test()``, the full-width parameters at ``vocos_mel_24khz()``,
and ``load_vocos_from_state_dict`` against JAX's reader.

Tolerances: the window and envelope tables exactly equal; ``istft``
within 1e-5 relative RMS (float32 inverse FFTs in other orders); the
decoded waveform within 1e-4 relative RMS (a whole model); readers
bit-equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_audioldm import _jax_reads
from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from tests.test_vocos import naive_istft
from v2ap_torch.models import vocos as t_vocos
from v2ap_torch.utils import torch_convert as t_tc
from v2ap_torch.utils.convert import _target, load_jax_params
from v2ap_tpu.models import vocos as j_vocos
from v2ap_tpu.utils import torch_convert as j_tc

torch.set_num_threads(2)

MODULE_REL_RMS = 1e-5
PATH_REL_RMS = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _spec(b: int, frames: int, n_fft: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bins = n_fft // 2 + 1
    return (rng.normal(size=(b, frames, bins))
            + 1j * rng.normal(size=(b, frames, bins))).astype(np.complex64)


def test_tables_equal_jax():
    for n in (16, 1024):
        np.testing.assert_array_equal(t_vocos._hann(n), j_vocos._hann(n))
    for args in ((11, 32, 8), (938, 1024, 256), (1, 16, 4), (5, 12, 5)):
        np.testing.assert_array_equal(t_vocos._envelope(*args),
                                      j_vocos._envelope(*args))


@pytest.mark.parametrize("frames,n_fft,hop", [(11, 32, 8), (30, 16, 4),
                                              (2, 64, 16), (40, 1024, 256)],
                         ids=["r4", "r4_long", "two_frames", "vocos"])
def test_istft_matches_jax_and_naive_overlap_add(frames, n_fft, hop):
    spec = _spec(2, frames, n_fft, frames)
    want = np.asarray(j_vocos.istft(jnp.asarray(spec), n_fft, hop))
    got = N(t_vocos.istft(torch.from_numpy(spec), n_fft, hop))
    assert got.shape == want.shape == (2, (frames - 1) * hop)
    assert rel_rms(got, want) < MODULE_REL_RMS
    assert rel_rms(got, naive_istft(spec.astype(np.complex128), n_fft,
                                    hop)) < MODULE_REL_RMS


def test_overlap_add_takes_any_hop():
    """``F.fold`` adds frame t at t * hop for a hop that does not divide the
    frame (JAX's shifted sum needs it to)."""
    td = np.random.default_rng(3).normal(size=(2, 6, 10)).astype(np.float32)
    want = np.zeros((2, 5 * 3 + 10), np.float32)
    for t in range(6):
        want[:, t * 3: t * 3 + 10] += td[:, t]
    np.testing.assert_allclose(N(t_vocos.overlap_add(T(td), 3)), want,
                               atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def vocos_pair():
    cfg = j_vocos.vocos_tiny_test()
    jm = j_vocos.Vocos(cfg, rngs=nnx.Rngs(0))
    randomize_jax(jm, 1, scale=0.2)
    tm = t_vocos.Vocos(t_vocos.vocos_tiny_test(), device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.mark.parametrize("layout", ["frames_last", "channels_first"])
def test_vocos_decode_matches_jax(vocos_pair, layout):
    jm, tm = vocos_pair
    mel = np.random.default_rng(2).normal(size=(2, 12, 8)).astype(np.float32)
    want = np.asarray(jm.decode(jnp.asarray(mel)))
    x = mel if layout == "frames_last" else mel.transpose(0, 2, 1).copy()
    with torch.no_grad():
        got = N(tm.decode(T(x)))
        feats = N(tm.backbone(T(mel)))
    assert got.shape == want.shape == (2, 11 * 4)
    assert rel_rms(got, want) < PATH_REL_RMS
    assert rel_rms(feats, np.asarray(jm.backbone(jnp.asarray(mel)))) \
        < MODULE_REL_RMS


def test_full_width_vocos_parameters_match_jax():
    """vocos-mel-24khz: every JAX parameter (built abstractly) placed in the
    port's (meta device) with its shape, none left over; 10 s of mel (938
    frames) decode to 239 872 samples."""
    assert j_vocos.vocos_mel_24khz() == j_vocos.VocosConfig()
    abstract = nnx.eval_shape(lambda: j_vocos.Vocos(rngs=nnx.Rngs(0)))
    shapes = {".".join(map(str, path)): tuple(v.shape) for path, v in
              nnx.to_flat_state(nnx.state(abstract, nnx.Param))}
    tm = t_vocos.Vocos(device="meta")
    tensors = dict(tm.named_parameters())
    placed = set()
    for key, shape in shapes.items():
        target, transform = _target(tm, key)
        assert tuple(tensors[target].shape) == transform(
            np.broadcast_to(np.float32(0), shape)).shape, key
        placed.add(target)
    assert placed == set(tensors)
    cfg = t_vocos.vocos_mel_24khz()
    assert (938 - 1) * cfg.hop_length == 239_872


def vocos_layout(model) -> dict:
    """{published key: shape} of charactr/vocos-mel-24khz's weights for the
    port's ``model``."""
    p = {k: list(v.shape) for k, v in model.named_parameters()}
    names = [("embed", "backbone.embed"), ("norm", "backbone.norm")]
    for i in range(len(model.blocks)):
        for n in ("dwconv", "norm", "pwconv1", "pwconv2"):
            names.append((f"blocks.{i}.{n}", f"backbone.convnext.{i}.{n}"))
    names += [("final_norm", "backbone.final_layer_norm"),
              ("head", "head.out")]
    out = {}
    for dst, key in names:
        out[f"{key}.weight"] = p[f"{dst}.weight"]
        out[f"{key}.bias"] = p[f"{dst}.bias"]
    for i in range(len(model.blocks)):
        out[f"backbone.convnext.{i}.gamma"] = p[f"blocks.{i}.gamma"]
    return out


def test_full_width_vocos_keys_are_what_jax_reads():
    """The published key list (``tests/golden/sd_keys_vocos_mel_24khz.json``)
    is exactly what JAX's reader reads into every parameter of its Vocos,
    and the port's reader consumes it all on the meta device."""
    layout = vocos_layout(t_vocos.Vocos(device="meta"))
    with open(os.path.join(GOLDEN, "sd_keys_vocos_mel_24khz.json")) as f:
        assert json.load(f) == layout
    _jax_reads(j_tc.load_vocos_from_state_dict,
               lambda: j_vocos.Vocos(rngs=nnx.Rngs(0)), layout)
    meta = torch.device("meta")
    sd = {k: torch.empty(s, device=meta) for k, s in layout.items()}
    assert t_tc.load_vocos_from_state_dict(
        sd, t_vocos.Vocos(device="meta")) == []


def test_vocos_reader_matches_jax():
    """One seeded state dict (plus the published file's feature-extractor
    and window buffers, left over) through both readers: equal weights,
    equal waveforms; a missing key and a misfit shape raise."""
    tm = t_vocos.Vocos(t_vocos.vocos_tiny_test(), device="cpu")
    g = torch.Generator().manual_seed(4)
    sd = {k: torch.randn(s, generator=g) * 0.2
          for k, s in vocos_layout(tm).items()}
    extra = {"feature_extractor.mel_spec.mel_scale.fb": torch.ones(9, 8),
             "head.istft.window": torch.ones(16)}
    sd.update(extra)
    jm = j_vocos.Vocos(j_vocos.vocos_tiny_test(), rngs=nnx.Rngs(1))
    j_tc.load_vocos_from_state_dict(sd, jm)
    assert t_tc.load_vocos_from_state_dict(sd, tm) == sorted(extra)
    want = t_vocos.Vocos(t_vocos.vocos_tiny_test(), device="cpu")
    load_jax_params(want, flatten_jax(jm))
    for (name, a), (_, b) in zip(tm.state_dict().items(),
                                 want.state_dict().items()):
        assert torch.equal(a, b), name
    mel = np.random.default_rng(5).normal(size=(1, 9, 8)).astype(np.float32)
    with torch.no_grad():
        got = N(tm.decode(T(mel)))
    assert rel_rms(got, np.asarray(jm.decode(jnp.asarray(mel)))) \
        < PATH_REL_RMS
    missing = dict(sd)
    del missing["backbone.convnext.1.gamma"]
    with pytest.raises(KeyError, match="convnext.1.gamma"):
        t_tc.load_vocos_from_state_dict(missing, tm)
    bad = dict(sd)
    bad["head.out.weight"] = torch.ones(3, 16)
    with pytest.raises(ValueError, match="does not fit"):
        t_tc.load_vocos_from_state_dict(bad, tm)
