"""The port's token path against the JAX package's, on the CPU in float32:
``data/tokenizers.py``, ``models/duration.py`` (``CharacterEmbed``,
``InterpolatedCharacterEmbed``, ``DurationPredictor`` forward, loss and
gradients), ``CFM(text_num_embeds=)`` / ``embed_tokens`` and
``data/extra_datasets.py``. Same seeded numpy inputs through both, weights
carried across by ``load_jax_params``, JAX's random draws handed in.

Tolerances: tokenizers, tables and batches exactly equal; the embeddings
within 1e-5 relative RMS; the predictor (a whole tri-stream transformer
eval) within 1e-4 relative RMS, its loss within 1e-4 relative and every
gradient tensor within 1e-4 relative RMS of ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import model_cfgs, rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch.data import audio_io as t_audio_io
from v2ap_torch.data import extra_datasets as t_extra
from v2ap_torch.data import tokenizers as t_tok
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.models import duration as t_dur
from v2ap_torch.utils.convert import _target, load_jax_params
from v2ap_tpu.data import extra_datasets as j_extra
from v2ap_tpu.data import tokenizers as j_tok
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.models import duration as j_dur

torch.set_num_threads(2)

EMBED_REL_RMS = 1e-5
PATH_REL_RMS = 1e-4


# --------------------------------------------------------------- tokenizers

@pytest.mark.parametrize("texts", [["hi", "abc"], ["héllo wörld", ""],
                                   ["日本語", "a"], []],
                         ids=["ascii", "utf8", "cjk", "empty"])
def test_byte_tokenizer_equals_jax(texts):
    enc, vocab = t_tok.byte_tokenizer()
    jenc, jvocab = j_tok.byte_tokenizer()
    got, want = enc(texts), jenc(texts)
    assert vocab == jvocab == 256
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_zh_table_and_ids_equal_jax():
    table, want = t_tok.zh_phoneme_table(), j_tok.zh_phoneme_table()
    assert table == want
    # the letter "a" takes the key of the pinyin syllable "a" (id 4)
    assert max(table.values()) == t_tok.ZH_NUM_PHONEMES - 1 == 1341
    assert table["a"] == table["A"] == 1314
    for toks in (["ni3", "hao3", "OK"], ["，", "a1", " ", "'"], ["Zoo"]):
        assert t_tok.zh_tokens_to_ids(toks, table) == \
            j_tok.zh_tokens_to_ids(toks, want)
    for bad in (["ni9"], ["中"]):
        with pytest.raises(KeyError):
            j_tok.zh_tokens_to_ids(bad, want)
        with pytest.raises(KeyError):
            t_tok.zh_tokens_to_ids(bad, table)


def test_phoneme_tokenizers_gate_as_jax():
    """English phonemes raise without ``g2p_en`` in both packages (or,
    where it is installed, encode alike); the Chinese one takes
    pre-segmented pinyin without ``jieba`` / ``pypinyin``."""
    texts = ["hello there.", "a b"]
    try:
        jenc, jvocab = j_tok.phoneme_en_tokenizer()
    except ImportError as exc:
        with pytest.raises(ImportError, match="g2p_en") as got:
            t_tok.phoneme_en_tokenizer()
        assert str(got.value) == str(exc)
    else:
        enc, vocab = t_tok.phoneme_en_tokenizer()
        assert vocab == jvocab
        np.testing.assert_array_equal(enc(texts), jenc(texts))
    zh = ["ni3 hao3", "OK", "，。", "ni3 hao3 ma"]
    enc, vocab = t_tok.phoneme_zh_tokenizer()
    jenc, jvocab = j_tok.phoneme_zh_tokenizer()
    assert vocab == jvocab == 1342
    np.testing.assert_array_equal(enc(zh), jenc(zh))


@pytest.mark.parametrize("name", ["char_utf8", "phoneme_zh", "nope"])
def test_get_tokenizer_equals_jax(name):
    if name == "nope":
        with pytest.raises(ValueError, match="unknown tokenizer 'nope'"):
            j_tok.get_tokenizer(name)
        with pytest.raises(ValueError, match="unknown tokenizer 'nope'"):
            t_tok.get_tokenizer(name)
        return
    enc, vocab = t_tok.get_tokenizer(name)
    jenc, jvocab = j_tok.get_tokenizer(name)
    assert vocab == jvocab
    np.testing.assert_array_equal(enc(["ni3 hao3", "ab"]),
                                  jenc(["ni3 hao3", "ab"]))


# --------------------------------------------------------------- embeddings

TOKENS = np.array([[5, 9, 2, -1, -1], [7, -1, -1, -1, -1],
                   [1, 2, 3, 4, 250]], np.int32)


@pytest.fixture(scope="module")
def char_embed():
    jm = j_dur.CharacterEmbed(8, rngs=nnx.Rngs(0))
    randomize_jax(jm, 1, scale=0.5)
    tm = t_dur.CharacterEmbed(8, device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.mark.parametrize("length", [3, 5, 12], ids=["curtail", "same",
                                                    "pad"])
def test_character_embed_matches_jax(char_embed, length):
    """Curtailed, as long, and zero-padded to the latent length; -1 lands on
    the filler row 0."""
    jm, tm = char_embed
    want = np.asarray(jm(jnp.asarray(TOKENS), length))
    with torch.no_grad():
        got = N(tm(T(TOKENS), length))
    assert got.shape == want.shape == (3, length, 8)
    assert rel_rms(got, want) < EMBED_REL_RMS
    filler = N(tm.embed.weight[0])
    np.testing.assert_array_equal(got[1, 1], filler)


@pytest.fixture(scope="module")
def interp_embed():
    jm = j_dur.InterpolatedCharacterEmbed(8, rngs=nnx.Rngs(0))
    randomize_jax(jm, 2, scale=0.5)
    tm = t_dur.InterpolatedCharacterEmbed(8, device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("length", [1, 4, 12])
def test_interpolated_character_embed_matches_jax(interp_embed, length,
                                                  masked):
    jm, tm = interp_embed
    mask = None
    if masked:
        mask = np.arange(length)[None] < np.array([[max(1, length // 2)],
                                                   [length], [1]])
    want = np.asarray(jm(jnp.asarray(TOKENS), length,
                         mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = N(tm(T(TOKENS), length,
                   mask=None if mask is None else T(mask)))
    assert got.shape == want.shape == (3, length, 8)
    assert rel_rms(got, want) < EMBED_REL_RMS
    if masked:
        assert not got[0, max(1, length // 2):].any()


@pytest.mark.parametrize("interpolated", [False, True],
                         ids=["character", "interpolated"])
def test_cfm_embed_tokens_matches_jax(interpolated):
    jcfg, tcfg = model_cfgs()
    jm = j_cfm.CFM(jcfg, with_video2roll=False, text_num_embeds=256,
                   interpolated_text=interpolated, rngs=nnx.Rngs(0))
    randomize_jax(jm, 3, scale=0.05)
    tm = t_cfm.CFM(tcfg, device="cpu", text_num_embeds=256,
                   interpolated_text=interpolated)
    load_jax_params(tm, flatten_jax(jm))
    want = np.asarray(jm.embed_tokens(jnp.asarray(TOKENS), 10))
    with torch.no_grad():
        got = N(tm.embed_tokens(T(TOKENS), 10))
    assert got.shape == want.shape == (3, 10, jcfg.dim_text)
    assert rel_rms(got, want) < EMBED_REL_RMS
    with pytest.raises(ValueError, match="text_num_embeds"):
        t_cfm.CFM(tcfg, device="cpu").embed_tokens(T(TOKENS), 10)


# ------------------------------------------------------- duration predictor

@pytest.fixture(scope="module")
def predictor_pair():
    jcfg, tcfg = model_cfgs()
    jm = j_dur.DurationPredictor(jcfg, rngs=nnx.Rngs(0))
    randomize_jax(jm, 4, scale=0.05)
    tm = t_dur.DurationPredictor(tcfg, device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm, jcfg


def _predictor_inputs(cfg):
    rng = np.random.default_rng(5)
    latents = rng.normal(size=(3, 24, cfg.num_channels)).astype(np.float32)
    tokens = np.array([[104, 105, -1], [97, 98, 99], [7, -1, -1]], np.int32)
    lens = np.array([20, 24, 9], np.int32)
    return latents, tokens, lens


@pytest.mark.parametrize("kind", ["tokens_lens", "no_tokens", "no_lens"])
def test_duration_predictor_forward_matches_jax(predictor_pair, kind):
    jm, tm, cfg = predictor_pair
    latents, tokens, lens = _predictor_inputs(cfg)
    tok = None if kind == "no_tokens" else tokens
    le = None if kind == "no_lens" else lens
    # one compiled program (eager dispatch compiles every primitive)
    want = np.asarray(nnx.jit(lambda m, *a: m(*a))(
        jm, jnp.asarray(latents), None if tok is None else jnp.asarray(tok),
        None if le is None else jnp.asarray(le)))
    with torch.no_grad():
        got = N(tm(T(latents), None if tok is None else T(tok),
                   None if le is None else T(le)))
    assert got.shape == want.shape == (3,)
    assert (got > 0).all()
    assert rel_rms(got, want) < PATH_REL_RMS


def _flat_grads(grads) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(grads)}


def test_duration_predictor_loss_and_grads_match_jax(predictor_pair):
    """``loss`` with JAX's ``frac`` (its ``jax.random.uniform`` draw) handed
    in, and every gradient against ``nnx.grad``'s."""
    jm, tm, cfg = predictor_pair
    latents, tokens, lens = _predictor_inputs(cfg)
    key = jax.random.key(11)
    frac = np.asarray(jax.random.uniform(key, (3,)))

    def jloss(m):
        return m.loss(jnp.asarray(latents), jnp.asarray(tokens),
                      jnp.asarray(lens), key)

    # one compiled program (eager dispatch compiles every primitive)
    want, jgrads = nnx.jit(nnx.value_and_grad(jloss))(jm)
    tm.zero_grad()
    got = tm.loss(T(latents), T(tokens), T(lens), frac=T(frac))
    got.backward()
    assert abs(got.item() - float(want)) <= PATH_REL_RMS * abs(float(want))
    params = dict(tm.named_parameters())
    seen = set()
    for key_, g in _flat_grads(jgrads).items():
        name, transform = _target(tm, key_)
        grad = params[name].grad      # None: the loss does not reach it
        port = N(grad) if grad is not None else np.zeros(params[name].shape)
        ref = transform(g)
        if not np.any(ref):
            np.testing.assert_allclose(port, 0.0, atol=1e-7, err_msg=key_)
        else:
            assert rel_rms(port, ref) < PATH_REL_RMS, key_
        seen.add(name)
    assert seen == set(params)


def test_duration_predictor_loss_draws_from_generator(predictor_pair):
    """Without ``frac`` the draw comes from the generator: the same seed
    gives the same loss, and it equals the loss with that draw handed in."""
    _, tm, cfg = predictor_pair
    latents, tokens, lens = _predictor_inputs(cfg)
    with torch.no_grad():
        a = tm.loss(T(latents), T(tokens), T(lens),
                    generator=torch.Generator().manual_seed(3))
        frac = torch.rand(3, generator=torch.Generator().manual_seed(3))
        b = tm.loss(T(latents), T(tokens), T(lens), frac=frac)
    assert float(a) == float(b)


# ------------------------------------------------------------------ datasets

class _Rows:
    """An in-memory stand-in with ``datasets.Dataset``'s row access."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _audio_rows():
    rng = np.random.default_rng(6)
    rows = []
    for i, (sr, secs) in enumerate([(16_000, 1.5), (24_000, 0.1),
                                    (22_050, 2.0), (48_000, 25.0),
                                    (24_000, 3.0)]):
        arr = rng.normal(size=int(sr * secs)).astype(np.float32) * 0.1
        rows.append({"audio": {"array": arr, "sampling_rate": sr},
                     "text": f"clip {i}"})
    return rows


@pytest.mark.parametrize("backing", ["datasets", "rows"])
def test_hf_audio_dataset_batches_equal_jax(backing):
    """Out-of-bounds clips (0.1 s, 25 s) skipped and redrawn, the rest
    resampled to 24 kHz and tiled: both packages' batches equal, over a
    ``datasets.Dataset`` built in memory and over plain rows."""
    rows = _audio_rows()
    if backing == "datasets":
        import datasets
        ds = datasets.Dataset.from_list(rows)
    else:
        ds = _Rows(rows)
    got = t_extra.HFAudioDataset(ds).batches(3, target_frames=40, seed=2)
    want = j_extra.HFAudioDataset(ds).batches(3, target_frames=40, seed=2)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["waveforms"], w["waveforms"])
        np.testing.assert_array_equal(g["lens"], w["lens"])
        assert g["captions"] == w["captions"]
        assert g["waveforms"].shape == (3, 40 * t_audio_io.HOP_SIZE)
    item = t_extra.HFAudioDataset(ds).get(1)
    assert item is None and j_extra.HFAudioDataset(ds).get(1) is None


def test_tts_dataset_batches_equal_jax(tmp_path):
    """A ``|`` / tab manifest with a missing wav: the same tokens, texts and
    waveforms in both packages, ``len`` oversampled."""
    rng = np.random.default_rng(7)
    lines = []
    for i, sep in enumerate(["|", "\t", "|"]):
        path = tmp_path / f"a{i}.wav"
        t_audio_io.write_wav(str(path), (rng.normal(size=(1, 24_000 + 800 * i))
                                         * 0.1).astype(np.float32))
        lines.append(f"{path}{sep}text {i} héllo")
    lines.append(f"{tmp_path / 'missing.wav'}|gone")
    lines.append("")
    scp = tmp_path / "tts.scp"
    scp.write_text("\n".join(lines) + "\n")
    ds, jds = (t_extra.TextToSpeechDataset(str(scp), multi=4),
               j_extra.TextToSpeechDataset(str(scp), multi=4))
    assert len(ds) == len(jds) == 16
    assert ds.rows == jds.rows
    got, want = ds.batches(4, target_frames=30, seed=1), \
        jds.batches(4, target_frames=30, seed=1)
    for _ in range(2):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in ("waveforms", "lens", "tokens"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["texts"] == w["texts"]

