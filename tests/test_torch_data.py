"""Parity of the port's training data layer (``v2ap_torch.data``: audio IO,
mixing, manifests, ``TrainBatcher``) with the JAX package's
``v2ap_tpu.data``, on the same files made from a numpy seed.

Tolerances: exact everywhere (the same numpy and scipy code on the same
inputs), except ``resample`` at 1e-7 absolute. The JAX package's native
decoder and max-energy search, where built, run on its side: the port's
stdlib reader and prefix sum must give the same samples and windows.
"""

import dataclasses
import json

import numpy as np
import pytest

from v2ap_torch import config as t_config
from v2ap_torch.data import audio_io as t_audio
from v2ap_torch.data import dataset as t_dataset
from v2ap_torch.data import manifests as t_man
from v2ap_torch.data import mixing as t_mix
from v2ap_tpu import config as j_config
from v2ap_tpu.data import audio_io as j_audio
from v2ap_tpu.data import dataset as j_dataset
from v2ap_tpu.data import manifests as j_man
from v2ap_tpu.data import mixing as j_mix

SR = 24_000


def _write(path, audio, sr=SR):
    t_audio.write_wav(str(path), audio, sr)
    return str(path)


def _noise(rng, seconds, sr=SR, ch=1, scale=0.2):
    return (rng.normal(size=(ch, int(seconds * sr))) * scale).astype(np.float32)


# ------------------------------------------------------------------ audio

def test_audio_constants_match_jax():
    assert (t_audio.SAMPLE_RATE, t_audio.HOP_SIZE, t_audio.TARGET_FRAMES) == \
        (j_audio.SAMPLE_RATE, j_audio.HOP_SIZE, j_audio.TARGET_FRAMES)


@pytest.mark.parametrize("sr", [16_000, 22_050, 44_100, 48_000, 24_000])
def test_resample_matches_jax(sr):
    x = _noise(np.random.default_rng(sr), 0.3, sr=sr, ch=2)
    got, want = t_audio.resample(x, sr), j_audio.resample(x, sr)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_normalize_pad_energy_match_jax():
    rng = np.random.default_rng(1)
    x = _noise(rng, 0.2) + 0.3
    np.testing.assert_array_equal(t_audio.normalize_wav(x),
                                  j_audio.normalize_wav(x))
    for length in (100, x.shape[-1], 3 * x.shape[-1] + 7):
        np.testing.assert_array_equal(t_audio.pad_or_repeat(x, length),
                                      j_audio.pad_or_repeat(x, length))
    np.testing.assert_array_equal(t_audio.frame_energy(x),
                                  j_audio.frame_energy(x))


@pytest.mark.parametrize("frames", [5, 14, 40])
def test_select_max_energy_segment_matches_jax(frames):
    """Below, at and above the clip's hop count; a loud burst inside."""
    rng = np.random.default_rng(frames)
    x = _noise(rng, 0.2, scale=0.05)                   # 15 hops
    x[0, 7 * 320: 9 * 320] *= 20.0
    got = t_audio.select_max_energy_segment(x, frames)
    want = j_audio.select_max_energy_segment(x, frames)
    np.testing.assert_array_equal(got, want)


def test_load_training_clip_matches_jax(tmp_path):
    """Mono 24 kHz, stereo 44.1 kHz and 16 kHz files, train and val windows;
    a silent and a missing file give None."""
    rng = np.random.default_rng(2)
    paths = [_write(tmp_path / "m.wav", _noise(rng, 1.3)),
             _write(tmp_path / "s.wav", _noise(rng, 0.7, sr=44_100, ch=2),
                    sr=44_100),
             _write(tmp_path / "l.wav", _noise(rng, 0.5, sr=16_000),
                    sr=16_000)]
    for p in paths:
        for val in (False, True):
            got = t_audio.load_training_clip(p, 60, val=val)
            want = j_audio.load_training_clip(p, 60, val=val)
            assert got.shape == (1, 60 * 320)
            np.testing.assert_array_equal(got, want)
    silent = _write(tmp_path / "z.wav", np.zeros((1, 4000), np.float32))
    for p in (silent, str(tmp_path / "missing.wav")):
        assert t_audio.load_training_clip(p, 60) is None
        assert j_audio.load_training_clip(p, 60) is None


# ----------------------------------------------------------------- mixing

def test_mixing_matches_jax():
    rng = np.random.default_rng(3)
    for fs, n_fft in ((16_000, 2048), (24_000, 3072), (44_100, 4096)):
        np.testing.assert_array_equal(t_mix.a_weight_db(fs, n_fft),
                                      j_mix.a_weight_db(fs, n_fft))
        s = _noise(rng, 0.5, sr=fs)[0]
        assert t_mix.perceptual_gain_db(s, fs) == j_mix.perceptual_gain_db(s, fs)
    short = np.ones(100, np.float32)
    assert t_mix.perceptual_gain_db(short, SR) == \
        j_mix.perceptual_gain_db(short, SR)
    with pytest.raises(ValueError):
        t_mix.perceptual_gain_db(short, 8000)
    s1, s2 = _noise(rng, 0.5), _noise(rng, 0.5, scale=0.01)
    for r in (0.25, 0.5, 0.75):
        np.testing.assert_array_equal(t_mix.mix_waveforms(s1, s2, r, SR),
                                      j_mix.mix_waveforms(s1, s2, r, SR))
    for a, b in (("Dog barks", "Rain"), ("", "x"), ("a", "")):
        assert t_mix.mix_captions(a, b) == j_mix.mix_captions(a, b)


# -------------------------------------------------------------- manifests

def _as_dicts(samples):
    return [dataclasses.asdict(s) for s in samples]


def test_manifests_match_jax(tmp_path):
    """scp (with and without captions), tango json, jsonl; limits, disabled
    and missing corpora, preference pairs and the leakage filter."""
    (tmp_path / "p").mkdir()
    scp = tmp_path / "a.scp"
    scp.write_text("x/one.wav\tA dog\n\nx/two.wav\ny/three.wav\tRain\n")
    js = tmp_path / "b.json"
    js.write_text(json.dumps({"data": [
        {"wav": "j/1.wav", "caption": "c1"}, {"location": "j/2.wav"},
        {"caption": "no path"}, {"path": "j/3.wav", "captions": "c3"}]}))
    jl = tmp_path / "c.jsonl"
    jl.write_text('{"wav": "l/1.wav", "caption": "l1"}\n\n'
                  '{"location": "l/2.wav", "captions": "l2"}\n')
    pairs = tmp_path / "p.scp"
    pairs.write_text("".join(f"{tmp_path}/p/{n}.wav\tclip\n"
                             for n in ("a01", "b01", "a02", "c03", "b04")))
    specs_t, specs_j = ([
        mod.CorpusSpec("a", str(scp), is_sound_effect=True),
        mod.CorpusSpec("b", str(js), is_video=True, limit=2),
        mod.CorpusSpec("c", str(jl), is_piano=True, is_video=True),
        mod.CorpusSpec("off", str(scp), enabled=False),
        mod.CorpusSpec("gone", str(tmp_path / "none.scp")),
        mod.CorpusSpec("p", str(pairs), preference_pairs=True)]
        for mod in (t_man, j_man))
    for exclude in (None, {"two", "2"}):
        got = t_man.load_corpora(specs_t, exclude_ids=exclude)
        want = j_man.load_corpora(specs_j, exclude_ids=exclude)
        assert _as_dicts(got) == _as_dicts(want) and got
    assert any(s.pair_path for s in got)
    assert not any(s.path.endswith("/two.wav") for s in got)
    for spec_t, spec_j in zip(specs_t, specs_j):
        assert _as_dicts(t_man.load_corpus(spec_t)) == \
            _as_dicts(j_man.load_corpus(spec_j))
    assert [dataclasses.asdict(s) for s in t_man.default_corpora("/r")] == \
        [dataclasses.asdict(s) for s in j_man.default_corpora("/r")]


# ---------------------------------------------------------------- batcher

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Sound-effect and other audio (24, 16 and 44.1 kHz, 0.3-1.4 s), one
    undecodable file, two video rows and a piano row with sibling wavs (one
    video without), and a/b preference pairs."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(4)
    audio, se, video, pairs = [], [], [], []
    for i in range(4):
        sr = (SR, 16_000, 44_100, SR)[i]
        audio.append((_write(tmp / f"n{i}.wav",
                             _noise(rng, 0.3 + 0.35 * i, sr=sr), sr),
                      f"Non-SE clip {i}"))
    for i in range(3):
        se.append((_write(tmp / f"s{i}.wav", _noise(rng, 0.5 + 0.2 * i)),
                   f"Effect {i}"))
    bad = tmp / "bad.wav"
    bad.write_bytes(b"RIFF not a wav")
    se.append((str(bad), "broken"))
    for i in range(3):
        stem = tmp / f"v{i}"
        if i < 2:
            _write(f"{stem}.wav", _noise(rng, 0.8))
        video.append((f"{stem}.mp4", f"video {i}", i == 2))
    (tmp / "pairs").mkdir()
    for j in range(2):
        for side in "ab":
            pairs.append(_write(tmp / "pairs" / f"{side}{j}.wav",
                                _noise(rng, 0.6)))
    return dict(audio=audio, se=se, video=video, pairs=pairs)


def _samples(mod, corpus, *, dpo=False):
    out = [mod.Sample(p, c, "n") for p, c in corpus["audio"]]
    out += [mod.Sample(p, c, "s", is_sound_effect=True)
            for p, c in corpus["se"]]
    out += [mod.Sample(p, c, "v", is_video=True, is_piano=piano)
            for p, c, piano in corpus["video"]]
    if dpo:
        rows = [mod.Sample(p, "pair", "p", is_video=True)
                for p in corpus["pairs"]]
        out += mod.pair_preferences(rows)
    return out


BATCHERS = {
    "mix": dict(batch_size=6, mix_prob=0.5),
    "no_mix": dict(batch_size=4, mix_prob=0.0, seed=7),
    "hosts": dict(batch_size=5, host_id=1, num_hosts=2, mix_prob=0.5),
    "dpo": dict(batch_size=8, dpo=True, micro_batches=2, mix_prob=0.5),
}


@pytest.mark.parametrize("kind", sorted(BATCHERS))
def test_train_batcher_matches_jax(corpus, kind):
    """The same seed and files give equal batches over 3 draws (waveforms
    exact, captions, video paths, piano flags, lens, both drop flags, the
    pair flag) and the same blacklist; the undecodable file lands in it."""
    kw = BATCHERS[kind]
    dpo = kw.get("dpo", False)
    data_t = dataclasses.replace(t_config.DataConfig(), target_length=60)
    data_j = dataclasses.replace(j_config.DataConfig(), target_length=60)
    bt = t_dataset.TrainBatcher(_samples(t_man, corpus, dpo=dpo), data_t, **kw)
    bj = j_dataset.TrainBatcher(_samples(j_man, corpus, dpo=dpo), data_j, **kw)
    flips = 0
    for _ in range(3):
        got, want = bt.next_batch(), bj.next_batch()
        assert got.waveforms.shape == (kw["batch_size"], 60 * 320)
        np.testing.assert_array_equal(got.waveforms, want.waveforms)
        for f in ("lens", "video_drop_prompt", "audio_drop_prompt"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for f in ("captions", "video_paths", "piano", "has_pairs"):
            assert getattr(got, f) == getattr(want, f), f
        flips += int(got.video_drop_prompt.sum())
    assert bt.blacklist == bj.blacklist
    assert flips > 0
    # the undecodable file, or the video without a sibling wav, was drawn
    assert bt.blacklist & {corpus["se"][-1][0], corpus["video"][2][0]}
    if dpo:
        mb = kw["batch_size"] // kw["micro_batches"]
        assert got.has_pairs and all(
            got.captions[i] == "pair" for i in (mb - 2, mb - 1, -2, -1))


def test_train_batcher_dpo_requires_pairs(corpus):
    with pytest.raises(ValueError, match="preference-pair"):
        t_dataset.TrainBatcher(_samples(t_man, corpus), dpo=True)
