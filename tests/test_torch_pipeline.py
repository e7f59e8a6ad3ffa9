"""The port's V2A serving slice end to end against the JAX package's, on
the CPU in float32: the same decoded frames through
``encode_video_frames_clip(..., frames_cache=...)``, then ``CFM.sample``
with CFG from the same x0, then ``EncodecModel.decode``, for both
pipelines with the JAX pipeline's weights carried across.

Tolerances: CLIP features atol 1e-5 (two tiny f32 towers); latents and the
waveform 1e-4 relative RMS (4 CFG steps of a 4-layer transformer in f32,
summation order differs).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch import config as t_config
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.pipelines import generate as t_generate
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.config import SamplerConfig
from v2ap_tpu.models.clip_vit import clip_tiny_test
from v2ap_tpu.models.t5 import t5_tiny_test
from v2ap_tpu.pipelines import generate as j_generate

torch.set_num_threads(2)


def _cfg(mod):
    """The tiny pipeline config (tower width 16, T5 width 32, 8 latent
    channels) with reference-parity conditioning and no feature caches."""
    cfg = mod.tiny_test()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dim_text=16, dim_context=32,
                                  num_channels=8, video2roll=False),
        conditioning=dataclasses.replace(cfg.conditioning, frame_stride=1,
                                         feature_cache=False))


@pytest.fixture(scope="module")
def pipelines():
    jp = j_generate.V2APipeline(_cfg(j_config), t5_config=t5_tiny_test(),
                                clip_config=clip_tiny_test(),
                                quantize_towers=False)
    for i, model in enumerate((jp.cfm, jp.codec, jp.clip)):
        randomize_jax(model, 20 + i, scale=0.05)
    tp = t_generate.V2APipeline(_cfg(t_config), device="cpu",
                                clip_config=t_clip.clip_tiny_test())
    load_jax_params(tp.cfm, flatten_jax(jp.cfm))
    with pytest.warns(UserWarning, match="encoder"):
        load_jax_params(tp.codec, flatten_jax(jp.codec))
    load_jax_params(tp.clip, flatten_jax(jp.clip))
    return jp, tp


def test_v2a_slice_matches_jax(pipelines):
    jp, tp = pipelines
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (12, 28, 28, 3), dtype=np.uint8)
    duration, n, n_valid = 1.0, 96, 75
    # the path is only a name here: the frames arrive decoded
    feats_j, dur_j = jp.encode_video_frames_clip(
        "clip.mp4", n, frames_cache=[(frames, duration, 1)])
    feats_t, dur_t = tp.encode_video_frames_clip(
        "clip.mp4", n, frames_cache=[(frames, duration, 1)])
    assert dur_j == dur_t == duration
    np.testing.assert_allclose(N(feats_t), np.asarray(feats_j), atol=1e-5,
                               rtol=1e-5)

    cfg = jp.cfg.model
    x0 = rng.normal(size=(1, n, cfg.num_channels)).astype(np.float32)
    roll = np.zeros((1, n, cfg.notes), np.float32)
    ctx = np.zeros((1, 1, cfg.dim_context), np.float32)
    cmask = np.ones((1, 1), bool)
    mask = np.arange(n)[None, :] < n_valid
    text = np.asarray(feats_j)[None]
    sampler = SamplerConfig(steps=4, cfg_strength=2.0)
    lat_j = jp._sample(jp.cfm, x0, text, roll, ctx, cmask, mask, sampler)
    with torch.no_grad():
        lat_t = tp.cfm.sample(
            T(x0), text_embed=feats_t[None], frames_embed=T(roll),
            context=T(ctx), context_mask=T(cmask), mask=T(mask),
            sampler=t_config.SamplerConfig(steps=4, cfg_strength=2.0))
        wav_t = tp.codec.decode(lat_t[:, :n_valid])
    assert rel_rms(N(lat_t), lat_j) < 1e-4
    wav_j = np.asarray(jp._decode(jp.codec, lat_j[:, :n_valid]))
    assert wav_j.shape == tuple(wav_t.shape) == (1, n_valid * 320)
    assert rel_rms(N(wav_t), wav_j) < 1e-4


def test_encode_video_file_matches_jax(pipelines, tmp_path):
    """A video file decoded by each pipeline itself (cv2), not handed in:
    the same duration and the same CLIP features, atol 1e-5."""
    cv2 = pytest.importorskip("cv2")
    jp, tp = pipelines
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             (28, 28))
    rng = np.random.default_rng(2)
    for _ in range(10):
        writer.write(rng.integers(0, 256, (28, 28, 3), dtype=np.uint8))
    writer.release()
    feats_j, dur_j = jp.encode_video_frames_clip(path, 96)
    feats_t, dur_t = tp.encode_video_frames_clip(path, 96)
    assert dur_t == dur_j
    np.testing.assert_allclose(N(feats_t), np.asarray(feats_j), atol=1e-5,
                               rtol=1e-5)


def test_generate_runs_on_cpu(pipelines):
    """The entry point end to end on decoded frames: finite audio of the
    clip's length; the same seed gives the same audio."""
    _, tp = pipelines
    frames = np.random.default_rng(1).integers(0, 256, (12, 28, 28, 3),
                                               dtype=np.uint8)
    wav, sr = tp.generate(None, steps=3, seed=5,
                          frames_cache=[(frames, 1.0, 1)])
    assert sr == 24_000 and wav.shape == (24_000,)
    assert np.isfinite(wav).all()
    again, _ = tp.generate(None, steps=3, seed=5,
                           frames_cache=[(frames, 1.0, 1)])
    np.testing.assert_array_equal(wav, again)
    assert set(tp.last_timings) == {"video_encode_s", "conditioning_s",
                                    "sample_s", "decode_s"}
    wav2, _ = tp.generate(None, duration_s=0.5, fewstep=2, seed=5)
    assert wav2.shape == (12_000,) and np.isfinite(wav2).all()


@pytest.mark.parametrize("kwargs", [dict(prompt="dog barking"),
                                    dict(piano=True), dict(passes=2)],
                         ids=["prompt", "piano", "passes"])
def test_generate_refuses_unported_modes(pipelines, kwargs):
    _, tp = pipelines
    with pytest.raises(NotImplementedError):
        tp.generate(None, duration_s=0.5, steps=2, **kwargs)


@pytest.mark.parametrize("change,kwargs", [
    (dict(frame_stride=3), {}), (dict(feature_cache=True), {}),
    ({}, dict(quantize_towers=True)), ({}, dict(quantize_cfm=True)),
    (dict(video_encoder="mixed"), {}),
], ids=["frame_stride", "feature_cache", "int8_towers", "int8_cfm",
        "other_towers"])
def test_pipeline_refuses_unported_conditioning(change, kwargs):
    cfg = _cfg(t_config)
    cfg = cfg.replace(conditioning=dataclasses.replace(cfg.conditioning,
                                                       **change))
    with pytest.raises(NotImplementedError):
        t_generate.V2APipeline(cfg, device="cpu", **kwargs)


def test_bucket_length_and_tokenizer_match_jax():
    for n in (1, 96, 97, 750, 2250):
        assert t_generate.bucket_length(n) == j_generate.bucket_length(n)
    prompts = ["a dog barks", "Rain on a tin roof"]
    for a, b in zip(t_generate.FallbackTokenizer(100)(prompts),
                    j_generate.FallbackTokenizer(100)(prompts)):
        np.testing.assert_array_equal(a, b)
