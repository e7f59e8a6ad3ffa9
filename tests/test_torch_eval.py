"""The port's evaluators against the JAX package's, on the CPU in float32:
``ops/melspec.py``, ``evaluation/metrics.py``, ``evaluation/pann.py``
(Cnn14) and ``models/clap.py`` (HTSAT + RoBERTa), the same seeded numpy
inputs through both, weights carried across by ``load_jax_params`` or read
by both packages from one state dict.

Tolerances: filterbanks and the metrics' float64 host math are copies (the
filterbanks exactly equal, the metrics within 1e-10 relative); log-mels
within 1e-3 (nats or dB) where the mel value is above its clip floor (the
FFTs round differently); the bicubic weight matrix within 1e-6 of
``jax.image.resize`` of an identity; Cnn14 and CLAP outputs within 1e-4
relative RMS (float32 convolutions and products in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch.evaluation import metrics as t_metrics
from v2ap_torch.evaluation import pann as t_pann
from v2ap_torch.models import clap as t_clap
from v2ap_torch.ops import melspec as t_mel
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu.evaluation import metrics as j_metrics
from v2ap_tpu.evaluation import pann as j_pann
from v2ap_tpu.models import clap as j_clap
from v2ap_tpu.ops import melspec as j_mel

torch.set_num_threads(2)

MEL_ATOL = 1e-3
MODEL_REL_RMS = 1e-4
METRIC_RTOL = 1e-10


def _above_floor(got, want, floor):
    keep = np.asarray(want) > floor
    assert keep.mean() > 0.5, "most of the mel must be above its floor"
    np.testing.assert_allclose(np.asarray(got)[keep], np.asarray(want)[keep],
                               atol=MEL_ATOL, rtol=0)


def _randomize_stats(model, seed: int) -> None:
    """BatchNorm running statistics of a JAX model from a seed (positive
    variances), so that the normalisations are not the identity."""
    rng = np.random.default_rng(seed)
    stats = nnx.state(model, nnx.BatchStat)
    nnx.update(model, jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape)
                              if x.ndim else x, x.dtype), stats))


# ------------------------------------------------------------------ melspec

@pytest.mark.parametrize("slaney_scale", [False, True], ids=["htk", "slaney"])
@pytest.mark.parametrize("slaney_norm", [False, True], ids=["none", "norm"])
@pytest.mark.parametrize("args", [(24_000, 1024, 100, 0.0, None),
                                  (16_000, 512, 64, 50.0, 8_000.0),
                                  (48_000, 1024, 64, 50.0, 14_000.0)],
                         ids=["24k", "pann16k", "clap48k"])
def test_mel_filterbank_equals_jax(args, slaney_norm, slaney_scale):
    want = j_mel.mel_filterbank(*args, slaney_norm=slaney_norm,
                                slaney_scale=slaney_scale)
    got = t_mel.mel_filterbank(*args, slaney_norm=slaney_norm,
                               slaney_scale=slaney_scale)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    ("default", dict()),
    ("short_window_power2", dict(n_fft=512, hop=160, win_length=400,
                                 n_mels=64, power=2.0, sr=16_000)),
    ("slaney_norm", dict(n_fft=1024, hop=160, n_mels=64, sr=16_000,
                         fmax=8_000.0, slaney_norm=True)),
], ids=lambda c: c[0])
def test_melspectrogram_matches_jax(case):
    kw = case[1]
    wav = np.random.default_rng(0).normal(size=(2, 12_000)).astype(np.float32)
    want = np.asarray(j_mel.melspectrogram(jnp.asarray(wav), **kw))
    got = N(t_mel.melspectrogram(T(wav), **kw))
    assert got.shape == want.shape
    _above_floor(got, want, np.log(1e-5))


def test_tacotron_mel_matches_jax():
    wav = np.random.default_rng(1).normal(size=(1, 16_000)).astype(np.float32)
    want = np.asarray(j_mel.tacotron_mel(jnp.asarray(wav)))
    got = N(t_mel.tacotron_mel(T(wav)))
    assert got.shape == want.shape == (1, 101, 64)
    _above_floor(got, want, np.log(1e-5))


def test_pann_logmel_matches_jax():
    cfg = j_pann.pann_16k()
    wav = (np.random.default_rng(2).normal(size=(2, 20_000)) * 0.1
           ).astype(np.float32)
    want = np.asarray(j_pann.pann_logmel(jnp.asarray(wav), cfg))
    got = N(t_pann.pann_logmel(T(wav), t_pann.pann_16k()))
    assert got.shape == want.shape == (2, 126, 64)
    _above_floor(got, want, -100.0)


def test_clap_logmel_matches_jax():
    wav = (np.random.default_rng(3).normal(size=(1, 48_000)) * 0.1
           ).astype(np.float32)
    want = j_clap.clap_logmel(wav)
    got = N(t_clap.clap_logmel(wav))
    assert got.shape == want.shape == (1, 1, 101, 64)
    _above_floor(got, want, -100.0)


# ------------------------------------------------------------------ bicubic

@pytest.mark.parametrize("n_in,n_out", [(1001, 1024), (64, 64), (100, 128),
                                        (7, 32)])
def test_bicubic_matrix_matches_jax_resize(n_in, n_out):
    """Resizing an identity along its first axis gives the weights."""
    want = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32),
                                       (n_out, n_in), "bicubic")).T
    got = t_clap.bicubic_matrix(n_in, n_out)
    assert got.shape == (n_in, n_out)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if n_in == n_out:
        np.testing.assert_array_equal(got, np.eye(n_in))


def test_bicubic_matrix_is_not_torch_bicubic():
    """``F.interpolate(mode="bicubic")`` (a = -0.75, clamped borders) is not
    JAX's resize; the matrix is."""
    x = np.random.default_rng(4).normal(size=(1, 1, 100, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 128, 8),
                                       "bicubic"))
    ours = np.einsum("bctf,tT->bcTf", x, t_clap.bicubic_matrix(100, 128))
    theirs = N(torch.nn.functional.interpolate(T(x), size=(128, 8),
                                               mode="bicubic"))
    assert rel_rms(ours, want) < 1e-6
    assert rel_rms(theirs, want) > 1e-3


# ------------------------------------------------------------------ metrics

def _emb_logits(seed, n=12, d=6, c=9):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=(n, c)) * 2.0


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=0)


def test_fad_and_frechet_equal_jax():
    (ra, _), (ga, _) = _emb_logits(0), _emb_logits(1)
    _close(t_metrics.fad_from_embeddings(ra, ga),
           j_metrics.fad_from_embeddings(ra, ga))
    mu, s = t_metrics.embedding_stats(ra)
    jmu, js = j_metrics.embedding_stats(ra)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(s, js)
    _close(t_metrics._sqrtm_psd(s), j_metrics._sqrtm_psd(js))


def test_kl_and_inception_score_equal_jax():
    (_, rl), (_, gl) = _emb_logits(2), _emb_logits(3)
    _close(t_metrics.kl_softmax(rl, gl), j_metrics.kl_softmax(rl, gl))
    _close(t_metrics.kl_sigmoid(rl, gl), j_metrics.kl_sigmoid(rl, gl))
    for splits in (1, 3, 10):
        _close(t_metrics.inception_score(gl, splits),
               j_metrics.inception_score(gl, splits))
    with pytest.raises(ValueError):
        t_metrics.kl_softmax(rl, gl[:3])


def test_audioldm_eval_metrics_equal_jax():
    """The metric set over the same registered embedder and classifier
    (numpy functions of the waveform): paired and unpaired."""
    rng = np.random.default_rng(5)
    proj_e, proj_c = rng.normal(size=(64, 5)), rng.normal(size=(64, 7))

    def embed(w, sr):
        return np.atleast_2d(w)[:, :64] @ proj_e

    def classify(w, sr):
        return np.atleast_2d(w)[:, :64] @ proj_c

    ref = [rng.normal(size=200).astype(np.float32) for _ in range(6)]
    gen = [rng.normal(size=200).astype(np.float32) for _ in range(6)]
    for r, g in ((ref, gen), (ref, gen[:4])):
        want = j_metrics.audioldm_eval_metrics(r, g, embedder=embed,
                                               classifier=classify)
        got = t_metrics.audioldm_eval_metrics(r, g, embedder=embed,
                                              classifier=classify)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])


# -------------------------------------------------------------------- Cnn14

@pytest.fixture(scope="module")
def cnn14_pair():
    from v2ap_tpu.utils.jitting import create_model
    cfg = j_pann.pann_tiny_test()
    jm = create_model(lambda: j_pann.Cnn14(cfg, rngs=nnx.Rngs(0)))
    randomize_jax(jm, 6, scale=0.1)
    _randomize_stats(jm, 7)
    tm = t_pann.Cnn14(t_pann.pann_tiny_test(), device="cpu").eval()
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_cnn14_embedding_and_logits_match_jax(cnn14_pair, seconds):
    jm, tm = cnn14_pair
    n = int(seconds * 16_000)
    wav = (np.random.default_rng(8).normal(size=(2, n)) * 0.1
           ).astype(np.float32)
    want_e = np.asarray(nnx.jit(lambda m, w: m(w))(jm, jnp.asarray(wav)))
    want_l = np.asarray(nnx.jit(lambda m, w: m.logits(w))(jm,
                                                          jnp.asarray(wav)))
    with torch.no_grad():
        got_e, got_l = N(tm(T(wav))), N(tm.logits(T(wav)))
    assert got_e.shape == want_e.shape == (2, 32)
    assert got_l.shape == want_l.shape == (2, 10)
    assert np.abs(want_e).max() > 0
    assert rel_rms(got_e, want_e) < MODEL_REL_RMS
    assert rel_rms(got_l, want_l) < MODEL_REL_RMS


def _pth_state_dict(cfg, seed: int) -> dict:
    """A synthetic state dict with the published ``Cnn14*.pth`` keys, plus a
    front-end table both readers leave alone."""
    rng = np.random.default_rng(seed)
    sd = {}

    def bn(key, c):
        sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{key}.bias"] = rng.normal(size=c) * 0.1
        sd[f"{key}.running_mean"] = rng.normal(size=c) * 0.1
        sd[f"{key}.running_var"] = rng.uniform(0.5, 1.5, c)

    bn("bn0", cfg.n_mels)
    cin = 1
    for i, cout in enumerate([64, 128, 256, 512, 1024, cfg.embed_dim], 1):
        for j, ci in ((1, cin), (2, cout)):
            sd[f"conv_block{i}.conv{j}.weight"] = (
                rng.normal(size=(cout, ci, 3, 3)) / np.sqrt(9 * ci))
            bn(f"conv_block{i}.bn{j}", cout)
        cin = cout
    e = cfg.embed_dim
    sd["fc1.weight"] = rng.normal(size=(e, e)) / np.sqrt(e)
    sd["fc1.bias"] = rng.normal(size=e) * 0.1
    sd["fc_audioset.weight"] = rng.normal(size=(cfg.num_classes, e)) / np.sqrt(e)
    sd["fc_audioset.bias"] = rng.normal(size=cfg.num_classes) * 0.1
    sd["logmel_extractor.melW"] = rng.normal(size=(257, 64))
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def test_load_pann_from_state_dict_matches_jax(cnn14_pair):
    jm, _ = cnn14_pair
    sd = _pth_state_dict(j_pann.pann_tiny_test(), 9)
    j_pann.load_pann_from_state_dict(sd, jm)
    tm = t_pann.Cnn14(t_pann.pann_tiny_test(), device="cpu").eval()
    t_pann.load_pann_from_state_dict(sd, tm)
    torch.testing.assert_close(tm.blocks[2].conv1.weight,
                               sd["conv_block3.conv1.weight"], rtol=0, atol=0)
    wav = (np.random.default_rng(10).normal(size=(1, 16_000)) * 0.1
           ).astype(np.float32)
    want = np.asarray(nnx.jit(lambda m, w: m.logits(w))(jm, jnp.asarray(wav)))
    with torch.no_grad():
        got = N(tm.logits(T(wav)))
    assert rel_rms(got, want) < MODEL_REL_RMS


def test_make_joint_resamples_and_equals_embedder_and_classifier():
    """One pass gives the embedder's and the classifier's outputs; a 24 kHz
    input is resampled to the model's 16 kHz on the host as in JAX."""
    cfg = t_pann.pann_tiny_test()
    joint = t_pann.make_joint(cfg, device="cpu")
    embed = t_pann.make_embedder(cfg, device="cpu")
    classify = t_pann.make_classifier(cfg, device="cpu")
    wav = (np.random.default_rng(11).normal(size=24_000) * 0.1
           ).astype(np.float32)
    e, l = joint(wav, 24_000)
    np.testing.assert_allclose(e, embed(wav, 24_000), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(l, classify(wav, 24_000), rtol=1e-6, atol=1e-6)
    assert e.shape == (1, 32) and l.shape == (1, 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pann.make_joint(cfg)            # CUDA unless asked for the CPU


# --------------------------------------------------------------------- CLAP

@pytest.fixture(scope="module")
def clap_pair():
    from v2ap_tpu.utils.jitting import create_model
    a, t = j_clap.clap_tiny_test()
    jm = create_model(lambda: j_clap.ClapModel(a, t, rngs=nnx.Rngs(0)))
    randomize_jax(jm, 12, scale=0.2)
    _randomize_stats(jm, 13)
    ta, tt = t_clap.clap_tiny_test()
    tm = t_clap.ClapModel(ta, tt, device="cpu").eval()
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm, a


@pytest.mark.parametrize("frames", [100, 128], ids=["resized", "exact"])
def test_clap_audio_features_match_jax(clap_pair, frames):
    """T < spec_w goes through the bicubic resize; T = spec_w does not."""
    jm, tm, a = clap_pair
    assert a.spec_size * a.freq_ratio == 128
    feats = np.random.default_rng(14).normal(
        size=(2, 1, frames, a.num_mel_bins)).astype(np.float32)
    want = np.asarray(nnx.jit(lambda m, f: m.get_audio_features(f))(
        jm, jnp.asarray(feats)))
    with torch.no_grad():
        got = N(tm.get_audio_features(T(feats)))
    assert got.shape == want.shape == (2, 24)
    assert rel_rms(got, want) < MODEL_REL_RMS


def _ids_mask():
    ids = np.asarray([[0, 7, 9, 12, 2, 1, 1], [0, 5, 2, 1, 1, 1, 1]],
                     np.int32)
    return ids, (ids != 1).astype(np.int32)


def test_clap_text_features_and_similarity_match_jax(clap_pair):
    jm, tm, a = clap_pair
    ids, mask = _ids_mask()
    want = np.asarray(nnx.jit(lambda m, i, k: m.get_text_features(i, k))(
        jm, jnp.asarray(ids), jnp.asarray(mask)))
    feats = np.random.default_rng(15).normal(
        size=(2, 1, 101, a.num_mel_bins)).astype(np.float32)
    want_s = np.asarray(nnx.jit(lambda m, f, i, k: m.similarity(f, i, k))(
        jm, jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = N(tm.get_text_features(T(ids).long(), T(mask)))
        got_s = N(tm.similarity(T(feats), T(ids).long(), T(mask)))
    assert got.shape == want.shape == (2, 24)
    assert rel_rms(got, want) < MODEL_REL_RMS
    assert rel_rms(got_s, want_s) < MODEL_REL_RMS


def test_swin_fixed_tables_equal_jax(clap_pair):
    jm, tm, _ = clap_pair
    np.testing.assert_array_equal(t_clap.relative_position_index(8),
                                  j_clap.relative_position_index(8))
    np.testing.assert_array_equal(t_clap.shift_attn_mask(16, 16, 4, 2),
                                  j_clap.shift_attn_mask(16, 16, 4, 2))
    blk = tm.audio_model.stages[0][0]
    assert blk.attn_mask is None and blk.shift == 0
    assert "audio_model.stages.0.0.attn.rel_index" not in tm.state_dict()


def test_load_jax_params_checks_clap_fixed_tables(clap_pair):
    """The converter checks the rebuilt tables (``rel_index``, the shift
    mask) instead of copying them, and never skips the ``bias_table``
    parameter."""
    jm, _, _ = clap_pair
    flat = flatten_jax(jm)
    ta, tt = t_clap.clap_tiny_test()
    tm = t_clap.ClapModel(ta, tt, device="cpu")
    key = "audio_model.stages.0.0.attn.rel_index"
    assert key in flat
    bad = dict(flat)
    bad[key] = flat[key][::-1].copy()
    with pytest.raises(ValueError, match="fixed table"):
        load_jax_params(tm, bad)
    short = {k: v for k, v in flat.items()
             if not k.endswith("attn.bias_table")}
    with pytest.raises(KeyError, match="bias_table"):
        load_jax_params(tm, short)
    tables = {k: v for k, v in flat.items()
              if not k.endswith(("rel_index", "attn_mask"))}
    load_jax_params(tm, tables)           # the tables may be left out


def test_load_clap_state_dict_matches_jax_torch_converter():
    """One tiny Hugging Face ClapModel read by ``load_clap_state_dict`` (the
    port, no transformers) and ``load_clap_from_torch`` (JAX): the same
    features, and the port equal to the HF model itself."""
    pytest.importorskip("transformers")
    from tests.test_clap import _hf_tiny, _jax_from_hf
    hf, cfgs = _hf_tiny(torch)
    jm = _jax_from_hf(hf, cfgs)
    ta, tt = t_clap.clap_tiny_test()
    tm = t_clap.ClapModel(ta, tt, device="cpu").eval()
    t_clap.load_clap_state_dict(hf.state_dict(), tm)
    a = cfgs[0]
    feats = np.random.default_rng(16).normal(
        size=(2, 1, a.spec_size * a.freq_ratio, a.num_mel_bins)
    ).astype(np.float32)
    ids, mask = _ids_mask()
    want_a = np.asarray(nnx.jit(lambda m, f: m.get_audio_features(f))(
        jm, jnp.asarray(feats)))
    want_t = np.asarray(nnx.jit(lambda m, i, k: m.get_text_features(i, k))(
        jm, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got_a = N(tm.get_audio_features(T(feats)))
        got_t = N(tm.get_text_features(T(ids).long(), T(mask)))
        hf_a = N(hf.get_audio_features(input_features=T(feats)))
    assert rel_rms(got_a, want_a) < MODEL_REL_RMS
    assert rel_rms(got_t, want_t) < MODEL_REL_RMS
    hf_a = hf_a / np.linalg.norm(hf_a, axis=-1, keepdims=True)
    np.testing.assert_allclose(got_a, hf_a, rtol=2e-3, atol=2e-4)
    bad = dict(hf.state_dict())
    key = ("audio_model.audio_encoder.layers.0.blocks.0.attention.self."
           "relative_position_index")
    bad[key] = bad[key].flip(0)
    with pytest.raises(ValueError, match="relative_position_index"):
        t_clap.load_clap_state_dict(bad, tm)
