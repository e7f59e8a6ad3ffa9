"""The port's serving slices end to end against the JAX package's, on the
CPU in float32, with the JAX pipeline's weights carried across: the same
decoded frames through ``encode_video_frames_clip(..., frames_cache=...)``
at frame stride 1 and 3, the same prompt through ``encode_text`` (T5), the
same keyboard strips through the roll path at strip stride 1 and 2
(``encode_piano_frames`` / ``_strided_strip_plan`` + ``_roll_from_strips``,
Video2Roll), then ``CFM.sample`` with CFG from the same x0, then
``EncodecModel.decode``.

Then the batched and multi-pass serving paths: ``generate_batch`` over
three clips (one without a video, one empty prompt) and
``generate(passes=2)``, each from the x0 and restart noise JAX draws
(``jax.random.normal`` on ``key(seed)``, the split chain of
``key(seed + 1)``), handed to the port; the on-disk feature caches read
across the packages; the environment switches the JAX pipeline reads.

Tolerances: CLIP features atol 1e-5 (two tiny f32 towers); the strided
features, the prompt context, the roll, latents and the waveform 1e-4
relative RMS (f32 matmuls and convolutions in another summation order).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline import write_synthetic_video
from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from tests.test_torch_video2roll import randomize_params_and_stats
from v2ap_torch import config as t_config
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.models import t5 as t_t5
from v2ap_torch.data import video_io as t_video_io
from v2ap_torch.evaluation import int8_gate as t_gate
from v2ap_torch.pipelines import generate as t_generate
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.config import SamplerConfig
from v2ap_tpu.data import video_io as j_video_io
from v2ap_tpu.evaluation import int8_gate as j_gate
from v2ap_tpu.models.clip_vit import clip_tiny_test
from v2ap_tpu.models.t5 import t5_tiny_test
from v2ap_tpu.pipelines import generate as j_generate

torch.set_num_threads(2)

PROMPT = "a calm piano piece in a quiet room"
STRIP_S = 0.4                  # 10 strips at 25 fps -> 11 Video2Roll windows


def _cfg(mod):
    """The tiny pipeline config (tower width 16, T5 width 32, 8 latent
    channels, Video2Roll) with reference-parity conditioning (frame and
    strip stride 1) and no feature caches."""
    cfg = mod.tiny_test()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dim_text=16, dim_context=32,
                                  num_channels=8, video2roll=True),
        conditioning=dataclasses.replace(cfg.conditioning, frame_stride=1,
                                         strip_stride=1, feature_cache=False))


def _port_pipeline(cfg, **kw):
    """The port's tiny pipeline on the CPU with bf16 (not int8) towers, the
    JAX pipeline's quantize_towers=False."""
    kw.setdefault("quantize_towers", False)
    return t_generate.V2APipeline(cfg, device="cpu",
                                  t5_config=t_t5.t5_tiny_test(),
                                  clip_config=t_clip.clip_tiny_test(), **kw)


@pytest.fixture(scope="module")
def pipelines():
    jp = j_generate.V2APipeline(_cfg(j_config), t5_config=t5_tiny_test(),
                                clip_config=clip_tiny_test(),
                                quantize_towers=False)
    for i, model in enumerate((jp.cfm, jp.codec, jp.clip, jp.t5)):
        randomize_jax(model, 20 + i, scale=0.05)
    randomize_params_and_stats(jp.cfm.video2roll, 24)
    tp = _port_pipeline(_cfg(t_config))
    load_jax_params(tp.cfm, flatten_jax(jp.cfm))
    load_jax_params(tp.codec, flatten_jax(jp.codec))
    load_jax_params(tp.clip, flatten_jax(jp.clip))
    load_jax_params(tp.t5, flatten_jax(jp.t5))
    return jp, tp


@contextlib.contextmanager
def strides(jp, tp, frame: int = 1, strip: int = 1):
    """Both pipelines at the given frame and strip strides (the JAX
    pipeline reads them once, at construction, into these attributes)."""
    saved = (jp._frame_stride, jp._strip_stride, tp.frame_stride,
             tp.strip_stride)
    jp._frame_stride = tp.frame_stride = frame
    jp._strip_stride = tp.strip_stride = strip
    try:
        yield
    finally:
        (jp._frame_stride, jp._strip_stride, tp.frame_stride,
         tp.strip_stride) = saved


def _strips():
    return np.random.default_rng(6).integers(0, 256, (10, 100, 900),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def rolls(pipelines):
    """{strip stride: (JAX roll, port roll)} for 10 strips of a 0.4 s clip
    at n = 96 latents, the JAX roll through its own methods."""
    jp, tp = pipelines
    strips, n = _strips(), 96
    out = {}
    with strides(jp, tp, strip=1):
        want = jp._roll_from_strips(jp._ship_strips(jp.encode_piano_frames(
            "clip.mp4", n, strips_cache=[(strips, STRIP_S)])), n)
        got = tp._roll_from_strips(tp._ship_strips(tp.encode_piano_frames(
            "clip.mp4", n, strips_cache=[(strips, STRIP_S)])), n)
        out[1] = (np.asarray(want), N(got))
    with strides(jp, tp, strip=2):
        want = jp._roll_from_strips(jp._strided_strip_plan(
            strips[::2], len(strips), STRIP_S, n), n)
        got = tp._roll_from_strips(tp._strided_strip_plan(
            strips[::2], len(strips), STRIP_S, n), n)
        out[2] = (np.asarray(want), N(got))
    return out


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
    assert set(tp.last_timings) == {"video_encode_s", "upload_s",
                                    "conditioning_s", "sample_s", "decode_s",
                                    "host_syncs", "since_init"}
    wav2, _ = tp.generate(None, duration_s=0.5, fewstep=2, seed=5)
    assert wav2.shape == (12_000,) and np.isfinite(wav2).all()


@pytest.mark.parametrize("mode", ["prompt", "piano", "passes"])
def test_generate_refuses_unported_modes(pipelines, mode):
    """What the port cannot serve raises, never falls back: piano=True with
    no strips and no video to decode (never a zero roll). A tokenizer path
    is served as JAX serves it: one that does not exist falls back to the
    hash tokenizer, a tokenizer directory is read, and a path that holds
    none raises. passes > 1 is ported: restart sampling serves finite audio
    that differs from one pass, the same on every call."""
    _, tp = pipelines
    if mode == "prompt":
        from tests.test_torch_hf_tokenizer import GOLDEN
        missing = _port_pipeline(_cfg(t_config),
                                 tokenizer_path="/t5/spiece.model")
        assert isinstance(missing.tokenize, t_generate.FallbackTokenizer)
        read = _port_pipeline(_cfg(t_config),
                              tokenizer_path=str(GOLDEN / "t5"))
        ids, mask = read.tokenize([PROMPT])
        assert ids.dtype == np.int32 and ids.shape == mask.shape
        assert ids[0, -1] == 1 and mask.all()            # ... </s>
        with pytest.raises(OSError):
            _port_pipeline(_cfg(t_config), tokenizer_path=str(GOLDEN))
    elif mode == "piano":
        with pytest.raises(ValueError, match="strips"):
            tp.generate(None, duration_s=0.5, steps=2, piano=True)
        with pytest.raises(RuntimeError, match="no keyboard strips"):
            tp.generate("missing.mp4", steps=2, piano=True)
    else:
        one, _ = tp.generate(None, duration_s=0.5, steps=2, seed=4)
        two, _ = tp.generate(None, duration_s=0.5, steps=2, seed=4, passes=2)
        again, _ = tp.generate(None, duration_s=0.5, steps=2, seed=4,
                               passes=2)
        assert two.shape == one.shape == (12_000,)
        assert np.isfinite(two).all() and not np.array_equal(two, one)
        np.testing.assert_array_equal(two, again)


@pytest.mark.parametrize("change,kwargs", [
    (dict(frame_stride=3), {}), (dict(feature_cache=True), {}),
    ({}, dict(quantize_towers=True)), ({}, dict(quantize_cfm=True)),
    (dict(video_encoder="mixed"), {}),
], ids=["frame_stride", "feature_cache", "int8_towers", "int8_cfm",
        "other_towers"])
def test_pipeline_refuses_unported_conditioning(pipelines, change, kwargs):
    """Unported conditioning raises at construction. A frame stride above 1
    is ported: what it refuses is a frames_cache holding frames at a step
    that is neither 1 (full rate) nor the stride. The feature caches are
    ported: such a pipeline builds, with the JAX package's cache tags. The
    other towers are ported: the mixed mode builds the four towers (tiny
    configs through ``tower_configs``), and only an unknown mode raises.
    int8 towers and the int8 CFM are ported: such a pipeline builds with
    every ``Linear`` of the towers (or the CFM) in int8 and JAX's tags."""
    cfg = _cfg(t_config)
    cfg = cfg.replace(conditioning=dataclasses.replace(cfg.conditioning,
                                                       **change))
    if "video_encoder" in change:
        from tests.test_torch_towers import T_TOWERS
        tp = _port_pipeline(cfg, tower_configs=T_TOWERS)
        assert [t.name for t in tp.towers] == ["clip_vit", "clip_vit2",
                                               "clip_convnext", "dinov2"]
        assert tp.video_embed_dim == 16 + 12 + 24 + 32
        bad = cfg.replace(conditioning=dataclasses.replace(
            cfg.conditioning, video_encoder="clip_vit3"))
        with pytest.raises(ValueError, match="not one of"):
            _port_pipeline(bad)
        return
    if "feature_cache" in change:
        tp = _port_pipeline(cfg)
        assert tp.cfg.conditioning.feature_cache
        assert (tp._tower_tag, tp._roll_tag) == ("bf16", "bf16")
        return
    if "frame_stride" in change:
        _, tp = pipelines
        frames = np.zeros((6, 28, 28, 3), np.uint8)
        with strides(*pipelines, frame=3), \
                pytest.raises(ValueError, match="frames_cache"):
            tp.generate(None, duration_s=0.5, steps=2,
                        frames_cache=[(frames, 1.0, 2)])
        return
    from v2ap_torch.ops.layers import Linear

    tp = _port_pipeline(cfg, **kwargs)
    int8_cfm = bool(kwargs.get("quantize_cfm"))
    assert all(m.int8 != int8_cfm for m in tp.clip.modules()
               if isinstance(m, Linear))
    assert all(m.int8 == int8_cfm for m in tp.cfm.modules()
               if isinstance(m, Linear))
    assert (tp._tower_tag, tp._roll_tag) == (
        ("bf16", "int8") if int8_cfm else ("int8", "bf16"))


def test_encode_text_matches_jax(pipelines):
    """A prompt through the tokenizer and T5: the context and its mask."""
    jp, tp = pipelines
    ctx_j, mask_j = jp.encode_text([PROMPT, "rain"])
    ctx_t, mask_t = tp.encode_text([PROMPT, "rain"])
    np.testing.assert_array_equal(N(mask_t), np.asarray(mask_j))
    assert N(mask_t).sum(1).tolist() == [9, 2]         # words + eos, of 64
    assert ctx_t.shape == (2, 64, 32)
    assert rel_rms(N(ctx_t), ctx_j) < 1e-4
    assert not N(ctx_t)[~N(mask_t)].any()


@pytest.mark.parametrize("cached_step", [1, 3], ids=["full_rate", "strided"])
def test_encode_video_frames_clip_stride3_matches_jax(pipelines, cached_step):
    """Frame stride 3: the tower over every third frame, then the linear
    blend to the latent rate, from full-rate frames or frames already at
    the stride."""
    jp, tp = pipelines
    frames = np.random.default_rng(3).integers(0, 256, (13, 28, 28, 3),
                                               dtype=np.uint8)
    cache = [(frames[::cached_step], 1.04, cached_step)]
    with strides(jp, tp, frame=3):
        feats_j, dur_j = jp.encode_video_frames_clip(
            "clip.mp4", 96, frames_cache=list(cache))
        feats_t, dur_t = tp.encode_video_frames_clip(
            "clip.mp4", 96, frames_cache=list(cache))
    assert dur_j == dur_t == 1.04
    assert feats_t.shape == (96, 16) and feats_t.dtype == torch.float32
    assert rel_rms(N(feats_t), feats_j) < 1e-4


@pytest.mark.parametrize("stride", [1, 2], ids=["strip_stride1",
                                                "strip_stride2"])
def test_roll_from_strips_matches_jax(rolls, stride):
    """The roll from full-rate strips (stride 1: strips at the roll rate)
    and from every second strip blended (stride 2), against JAX's
    encode_piano_frames / _strided_strip_plan + _roll_from_strips."""
    want, got = rolls[stride]
    assert got.shape == want.shape == (1, 96, 51)
    assert rel_rms(got, want) < 1e-4
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert not got[0, 33:].any() and got[0, :33].any()   # 11 windows x3


def test_sample_with_roll_and_prompt_matches_jax(pipelines, rolls):
    """CFM.sample with the stride-2 roll and a prompt context (its mask
    kept in the CFG null branch, whose context is zeroed), from one x0."""
    jp, tp = pipelines
    ctx_j, mask_j = jp.encode_text([PROMPT])
    ctx_t, mask_t = tp.encode_text([PROMPT])
    roll_j, roll_t = rolls[2]
    cfg = jp.cfg.model
    n, n_valid = 96, 30
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(1, n, cfg.num_channels)).astype(np.float32)
    text = rng.normal(size=(1, n, cfg.dim_text)).astype(np.float32)
    mask = np.arange(n)[None, :] < n_valid
    sampler = SamplerConfig(steps=4, cfg_strength=2.0)
    lat_j = jp._sample(jp.cfm, x0, text, roll_j, ctx_j, mask_j, mask, sampler)
    with torch.no_grad():
        lat_t = tp.cfm.sample(
            T(x0), text_embed=T(text), frames_embed=T(roll_t), context=ctx_t,
            context_mask=mask_t, mask=T(mask),
            sampler=t_config.SamplerConfig(steps=4, cfg_strength=2.0))
    err = rel_rms(N(lat_t), lat_j)
    assert err < 1e-4
    # the prompt moves the result by far more than the two packages differ
    with torch.no_grad():
        no_prompt = tp.cfm.sample(
            T(x0), text_embed=T(text), frames_embed=T(roll_t),
            context=torch.zeros_like(ctx_t[:, :1]),
            context_mask=mask_t[:, :1], mask=T(mask),
            sampler=t_config.SamplerConfig(steps=4, cfg_strength=2.0))
    assert rel_rms(N(no_prompt), N(lat_t)) > 10 * err


def test_generate_v2p_with_prompt_runs_on_cpu(pipelines):
    """The entry point at the shipped strides (frame 3, strip 2) with a
    prompt and piano=True, frames and strips handed in decoded: finite
    audio of the strips' duration, a roll in [0, 1], the T5 and Video2Roll
    stages timed; an explicit duration takes the exact (every strip)
    path."""
    _, tp = pipelines
    frames = np.random.default_rng(1).integers(0, 256, (10, 28, 28, 3),
                                               dtype=np.uint8)
    strips = _strips()
    with strides(*pipelines, frame=3, strip=2):
        wav, sr = tp.generate(None, PROMPT, piano=True, steps=2, seed=5,
                              frames_cache=[(frames, STRIP_S, 1)],
                              strips_cache=[(strips, STRIP_S)])
        roll = N(tp.last_roll)
        assert set(tp.last_timings) == {
            "strips_s", "video_encode_s", "upload_s", "text_encode_s",
            "roll_s", "conditioning_s", "sample_s", "decode_s", "host_syncs",
            "since_init"}
        exact, _ = tp.generate(None, PROMPT, piano=True, steps=2, seed=5,
                               duration_s=STRIP_S,
                               frames_cache=[(frames, STRIP_S, 1)],
                               strips_cache=[(strips, STRIP_S)])
    assert sr == 24_000 and wav.shape == exact.shape == (9_600,)
    assert np.isfinite(wav).all() and np.isfinite(exact).all()
    assert roll.shape == (96, 51) and 0.0 <= roll.min() and roll.max() <= 1.0
    assert roll[:33].any() and not roll[33:].any()


def test_generate_v2p_from_a_video_file_matches_decoded_caches(pipelines,
                                                               tmp_path):
    """piano=True from a video path at the shipped strides (one fused
    decode: RGB at the frame stride, strips at the strip stride) gives the
    same audio and roll as the full-rate frames and strips handed in
    decoded through frames_cache and strips_cache."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "keys.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (64, 48))
    rng = np.random.default_rng(9)
    for _ in range(10):
        writer.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    writer.release()
    frames, dur = t_generate.video_io.read_video_frames(path)
    strips = t_generate.video_io.piano_preprocess(frames)
    _, tp = pipelines
    kw = dict(prompt=PROMPT, piano=True, steps=2, seed=3)
    with strides(*pipelines, frame=3, strip=2):
        wav_file, _ = tp.generate(path, **kw)
        roll_file = N(tp.last_roll)
        wav_cache, _ = tp.generate(None, frames_cache=[(frames, dur, 1)],
                                   strips_cache=[(strips, dur)], **kw)
        roll_cache = N(tp.last_roll)
    assert wav_file.shape == (9_600,) and np.isfinite(wav_file).all()
    np.testing.assert_array_equal(roll_file, roll_cache)
    np.testing.assert_array_equal(wav_file, wav_cache)


def test_bucket_length_and_tokenizer_match_jax():
    for n in (1, 96, 97, 750, 2250):
        assert t_generate.bucket_length(n) == j_generate.bucket_length(n)
    prompts = ["a dog barks", "Rain on a tin roof"]
    for a, b in zip(t_generate.FallbackTokenizer(100)(prompts),
                    j_generate.FallbackTokenizer(100)(prompts)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ batched serving

def _jax_normal(seed, shape):
    return np.array(jax.random.normal(jax.random.key(seed), shape))


def _jax_restart_noises(key_seed, passes, shape):
    """The restart noise of JAX's ``sample_multipass(rng=key(key_seed))``:
    pass p draws from the second half of the p-th split of the chain."""
    rng, out = jax.random.key(key_seed), []
    for _ in range(1, passes):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _jax_draws(seed):
    """A stand-in for the port's ``_normal``: JAX's x0 for ``seed``, and
    for ``seed + 1`` the restart noise chain, as the JAX pipeline draws
    them."""
    def normal(s, shape):
        if s == seed:
            return T(_jax_normal(seed, shape))
        assert s == seed + 1, (s, seed)
        return T(_jax_restart_noises(seed + 1, shape[0] + 1, shape[1:]))
    return normal


def _videos(tmp_path):
    """Two short synthetic clips of different lengths and rates (cv2)."""
    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    assert write_synthetic_video(a, frames=10, fps=10)
    assert write_synthetic_video(b, frames=6, fps=8, size=(48, 64))
    return a, b


@pytest.mark.parametrize("piano", [False, True], ids=["v2a", "v2p"])
def test_generate_batch_matches_jax(pipelines, tmp_path, piano):
    """generate_batch over three clips (a video with an empty prompt, no
    video with a prompt, a second video with another prompt) at 1 s, from
    JAX's x0: every clip within 1e-4 rel-RMS of JAX's generate_batch, V2A
    and V2P (strip stride 2); the clip without a video gets zero
    features and a zero roll, as in JAX."""
    jp, tp = pipelines
    a, b = _videos(tmp_path)
    paths, prompts = [a, None, b], ["", PROMPT, "rain on a tin roof"]
    seed, n, c = 11, 96, jp.cfg.model.num_channels
    x0 = _jax_normal(seed, (3, n, c))
    with strides(jp, tp, frame=1, strip=2 if piano else 1):
        want, sr_j = jp.generate_batch(paths, prompts, duration_s=1.0,
                                       steps=3, piano=piano, seed=seed)
        got, sr_t = tp.generate_batch(paths, prompts, duration_s=1.0,
                                      steps=3, piano=piano, seed=seed, x0=x0)
    assert sr_j == sr_t == 24_000
    assert got.shape == want.shape == (3, 24_000)
    for i in range(3):
        assert rel_rms(got[i], want[i]) < 1e-4, i
    assert set(tp.last_timings) == {
        "conditioning_s", "video_encode_s", "upload_s", "text_encode_s",
        "sample_s", "decode_s", "host_syncs", "since_init"} | (
            {"strips_s", "roll_s"} if piano else set())


def test_generate_batch_with_decoded_frames_matches_paths(pipelines, tmp_path):
    """Clips handed in decoded (frames_caches) give the audio their video
    files give, and the port's own x0 draw (seed) is repeatable."""
    _, tp = pipelines
    a, b = _videos(tmp_path)
    caches = [[t_video_io.read_video_frames(p) + (1,)] for p in (a, b)]
    from_files, _ = tp.generate_batch([a, b], ["", ""], duration_s=1.0,
                                      steps=2, seed=3)
    from_frames, _ = tp.generate_batch([None, None], ["", ""],
                                       duration_s=1.0, steps=2, seed=3,
                                       frames_caches=caches)
    np.testing.assert_array_equal(from_frames, from_files)
    assert not np.array_equal(from_frames[0], from_frames[1])


def test_sample_multipass_matches_jax(pipelines):
    """Three passes from restart_t 0.5 through each pipeline's multi-pass
    sampler program, the port given JAX's noise chain of key(8)."""
    jp, tp = pipelines
    cfg = jp.cfg.model
    n, n_valid, passes, restart_t = 96, 60, 3, 0.5
    rng = np.random.default_rng(12)
    x0 = rng.normal(size=(2, n, cfg.num_channels)).astype(np.float32)
    text = rng.normal(size=(2, n, cfg.dim_text)).astype(np.float32)
    roll = np.zeros((2, n, cfg.notes), np.float32)
    ctx = np.zeros((2, 1, cfg.dim_context), np.float32)
    cmask = np.ones((2, 1), bool)
    mask = np.repeat(np.arange(n)[None, :] < n_valid, 2, axis=0)
    lat_j = jp._sample_multipass(jp.cfm, x0, text, roll, ctx, cmask, mask,
                                 SamplerConfig(steps=4, cfg_strength=2.0),
                                 jax.random.key(8), passes, restart_t)
    noises = _jax_restart_noises(8, passes, x0.shape)
    lat_t = tp._sample_multipass(
        T(x0), T(text), T(roll), T(ctx), T(cmask), T(mask),
        t_config.SamplerConfig(steps=4, cfg_strength=2.0), T(noises), passes,
        restart_t)
    assert lat_t.shape == (2, n, cfg.num_channels)
    assert rel_rms(N(lat_t), lat_j) < 1e-4
    one = tp._sample(T(x0), T(text), T(roll), T(ctx), T(cmask), T(mask),
                     t_config.SamplerConfig(steps=4, cfg_strength=2.0))
    assert rel_rms(N(one), N(lat_t)) > 1e-2          # the passes matter
    # without noises, CFM.sample_multipass draws them all from the
    # generator before the first step
    kw = dict(passes=passes, restart_t=restart_t, text_embed=T(text),
              frames_embed=T(roll), context=T(ctx), context_mask=T(cmask),
              mask=T(mask), sampler=t_config.SamplerConfig(steps=4))
    with torch.inference_mode():
        drawn = tp.cfm.sample_multipass(
            T(x0), generator=torch.Generator().manual_seed(9), **kw)
        given = tp.cfm.sample_multipass(
            T(x0), noises=torch.randn((passes - 1,) + x0.shape,
                                      generator=torch.Generator().manual_seed(9)),
            **kw)
    assert torch.equal(drawn, given)


def test_generate_passes2_matches_jax(pipelines, tmp_path, monkeypatch):
    """generate(passes=2) from a video file: x0 from key(seed) and the
    restart noise from key(seed + 1)'s split chain, as JAX draws them."""
    jp, tp = pipelines
    a, _ = _videos(tmp_path)
    seed = 5
    monkeypatch.setattr(tp, "_normal", _jax_draws(seed))
    want, _ = jp.generate(a, steps=3, seed=seed, passes=2, restart_t=0.6)
    got, _ = tp.generate(a, steps=3, seed=seed, passes=2, restart_t=0.6)
    assert got.shape == want.shape == (24_000,)
    assert rel_rms(got, want) < 1e-4


# --------------------------------------------------------------- feature caches

@contextlib.contextmanager
def feature_caches(*pipes):
    """The pipelines with ConditioningConfig.feature_cache on (both read it
    at call time)."""
    saved = [p.cfg for p in pipes]
    for p in pipes:
        p.cfg = p.cfg.replace(conditioning=dataclasses.replace(
            p.cfg.conditioning, feature_cache=True))
    try:
        yield
    finally:
        for p, cfg in zip(pipes, saved):
            p.cfg = cfg


def test_cache_files_cross_between_packages(tmp_path):
    """save_feature_cache / load_feature_cache: a file either package
    writes, the other reads, tag check included; the cache paths agree."""
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(7, 16)).astype(np.float32)
    strips = rng.integers(0, 256, (5, 100, 900), dtype=np.uint8)
    for writer, reader in ((j_video_io, t_video_io), (t_video_io, j_video_io)):
        f, s = str(tmp_path / "f.npz"), str(tmp_path / "s.npz")
        writer.save_feature_cache(f, feats, 1.25, tag="bf16+s3")
        writer.save_feature_cache(s, strips, 0.2)
        got, dur = reader.load_feature_cache(f, tag="bf16+s3")
        np.testing.assert_array_equal(got, feats)
        assert dur == 1.25
        assert reader.load_feature_cache(f, tag="bf16") == (None, None)
        got, dur = reader.load_feature_cache(s)
        np.testing.assert_array_equal(got, strips)
        assert dur == 0.2
    for fn in ("clip_feature_cache_path", "piano_frames_cache_path",
               "piano_roll_cache_path"):
        assert getattr(t_video_io, fn)("/v/x.mp4") == \
            getattr(j_video_io, fn)("/v/x.mp4")


def test_bf16_feature_cache_from_jax_reads_in_the_port(tmp_path):
    """A bfloat16 feature array as the JAX package saves it (numpy reads
    its values back as two-byte voids) loads as the same bf16 values."""
    feats = jnp.asarray(np.random.default_rng(5).normal(size=(6, 16)),
                        jnp.bfloat16)
    path = str(tmp_path / "x.generated.npz")
    j_video_io.save_feature_cache(path, np.asarray(feats), 1.0, tag="bf16")
    raw, _ = t_video_io.load_feature_cache(path, tag="bf16")
    got = t_generate._feature_tensor(raw, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(feats.astype(jnp.float32)))


def test_frame_feature_cache_crosses_pipelines(pipelines, tmp_path,
                                               monkeypatch):
    """With feature_cache on, the frame features one pipeline computed for
    a video (tagged, beside it) answer the other's call without running
    its tower, in both directions; the tags are JAX's."""
    jp, tp = pipelines
    a, b = _videos(tmp_path)
    assert tp._tower_tag == jp._tower_tag == "bf16"

    def no_tower(*args, **kw):
        raise AssertionError("the tower ran although the cache was there")

    with feature_caches(jp, tp):
        want_a, _ = jp.encode_video_frames_clip(a, 96)    # JAX writes a
        feats_b, _ = tp.encode_video_frames_clip(b, 96)   # the port writes b
        with monkeypatch.context() as m:
            m.setattr(tp.clip, "forward", no_tower)
            got_a, _ = tp.encode_video_frames_clip(a, 96)
        with monkeypatch.context() as m:
            m.setattr(jp, "_tower_fwd", no_tower)
            got_b, _ = jp.encode_video_frames_clip(b, 96)
    np.testing.assert_allclose(N(got_a), np.asarray(want_a), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_b), N(feats_b), atol=1e-6)


def test_roll_cache_written_by_jax_serves_the_port(pipelines, tmp_path,
                                                   monkeypatch):
    """A V2P generate in JAX writes the strip and roll caches beside the
    video; the port's generate(piano=True) then takes the roll from the
    cache (Video2Roll does not run) and serves audio within 1e-4 of
    JAX's from the same x0."""
    jp, tp = pipelines
    a, _ = _videos(tmp_path)
    seed = 2

    def no_roll(*args, **kw):
        raise AssertionError("Video2Roll ran although the roll was cached")

    with feature_caches(jp, tp):
        want, _ = jp.generate(a, piano=True, steps=2, seed=seed)
        roll, _ = j_video_io.load_feature_cache(
            j_video_io.piano_roll_cache_path(a), tag="bf16")
        assert tp._roll_tag == jp._roll_tag == "bf16"
        monkeypatch.setattr(tp, "_normal", _jax_draws(seed))
        monkeypatch.setattr(tp.cfm, "encode_frames", no_roll)
        got, _ = tp.generate(a, piano=True, steps=2, seed=seed)
    np.testing.assert_array_equal(N(tp.last_roll), roll)
    assert rel_rms(got, want) < 1e-4


# --------------------------------------------------------- environment switches

def test_tokenizer_switch_raises_where_jax_loads_one(monkeypatch, tmp_path):
    """V2AP_T5_TOKENIZER naming a tokenizer directory (where JAX loads the
    HF tokenizer) gives JAX's ids and masks exactly; naming a missing path,
    JAX falls back to the hash tokenizer, and so does the port."""
    from tests.test_torch_hf_tokenizer import GOLDEN
    prompts = [PROMPT, "", "the sound of rain on a roof, then thunder"]
    monkeypatch.setenv("V2AP_T5_TOKENIZER", str(GOLDEN / "t5"))
    tp = _port_pipeline(_cfg(t_config))
    want = j_generate.load_t5_tokenizer(None, tp.t5_cfg.vocab_size)
    for x, y in zip(tp.tokenize(prompts), want(prompts)):
        np.testing.assert_array_equal(x, y)
    monkeypatch.setenv("V2AP_T5_TOKENIZER", str(tmp_path / "missing"))
    tp = _port_pipeline(_cfg(t_config))
    want = j_generate.load_t5_tokenizer(None, tp.t5_cfg.vocab_size)
    assert isinstance(want, j_generate.FallbackTokenizer)
    for x, y in zip(tp.tokenize([PROMPT]), want([PROMPT])):
        np.testing.assert_array_equal(x, y)


def test_stride_switches_match_jax(monkeypatch):
    """V2AP_FRAME_STRIDE and V2AP_STRIP_STRIDE override the config's
    strides and tag the caches exactly as in the JAX pipeline; "0" means
    1 and an empty value the config's stride."""
    for frame, strip in (("3", "2"), ("0", "")):
        monkeypatch.setenv("V2AP_FRAME_STRIDE", frame)
        monkeypatch.setenv("V2AP_STRIP_STRIDE", strip)
        jp = j_generate.V2APipeline(_cfg(j_config), t5_config=t5_tiny_test(),
                                    clip_config=clip_tiny_test(),
                                    quantize_towers=False)
        tp = _port_pipeline(_cfg(t_config))
        assert (tp.frame_stride, tp.strip_stride) == \
            (jp._frame_stride, jp._strip_stride)
        assert (tp._tower_tag, tp._roll_tag) == (jp._tower_tag, jp._roll_tag)
    assert (tp.frame_stride, tp._tower_tag) == (1, "bf16")


@pytest.mark.parametrize("env,gate,builds", [
    (None, None, False), ("1", None, False), ("0", None, True),
    (None, False, True), (None, True, False), ("0", True, True),
], ids=["default_int8", "env_int8", "env_bf16", "gate_bf16", "gate_int8",
        "env_over_gate"])
def test_int8_tower_default_follows_jax(monkeypatch, tmp_path, env, gate,
                                        builds):
    """quantize_towers=None means JAX's default: V2AP_INT8_TOWERS if set,
    else the int8 gate's verdict file, else int8. ``builds`` names the bf16
    cases; the others build int8 towers (tagged "int8"), as JAX's do. The
    port's copy of the gate reader agrees with JAX's."""
    gate_file = tmp_path / "gate.json"
    if gate is not None:
        gate_file.write_text(f'{{"int8_default": {str(gate).lower()}}}')
    monkeypatch.setenv("V2AP_INT8_GATE_FILE", str(gate_file))
    if env is None:
        monkeypatch.delenv("V2AP_INT8_TOWERS", raising=False)
    else:
        monkeypatch.setenv("V2AP_INT8_TOWERS", env)
    assert t_gate.gate_file_path() == j_gate.gate_file_path()
    assert t_gate.read_gate_default() == j_gate.read_gate_default() == gate
    tp = _port_pipeline(_cfg(t_config), quantize_towers=None)
    assert tp.quantize_towers is not builds
    assert tp._tower_tag == ("bf16" if builds else "int8")


@pytest.mark.parametrize("var", ["V2AP_INT8_CFM", "V2AP_SHIP_YUV420",
                                 "V2AP_SHIP_STRIP_HALF"])
def test_other_result_switches_raise(monkeypatch, var):
    """The JAX pipeline's other switches that change its result, each
    ported and read as JAX reads it: V2AP_INT8_CFM=1 builds the int8 CFM
    (every ``Linear`` of the CFM in int8, the roll cache tagged "int8"),
    the wire-level shipping modes tag the caches as JAX's ("+yuv420" on
    the features; "+shalf" on the roll, with strip stride 1)."""
    monkeypatch.setenv(var, "1")
    tp = _port_pipeline(_cfg(t_config))
    if var == "V2AP_INT8_CFM":
        assert tp.quantize_cfm and tp._roll_tag == "int8"
    elif var == "V2AP_SHIP_YUV420":
        assert tp.ship_yuv420 and tp._tower_tag.endswith("+yuv420")
    else:
        assert tp.ship_strip_half and tp.strip_stride == 1
        assert tp._roll_tag == "bf16+shalf"


def test_generate_to_file_writes_the_wav_without_ffmpeg(pipelines, tmp_path):
    """generate_to_file returns the target path; without ffmpeg (as here)
    the audio lands in <target stem>.wav, the file JAX writes too."""
    import shutil

    from v2ap_torch.data.audio_io import read_wav
    if shutil.which("ffmpeg"):
        pytest.skip("an ffmpeg is installed: the muxed file is written")
    _, tp = pipelines
    a, _ = _videos(tmp_path)
    out = str(tmp_path / "out" / "a.generated.mp4")
    assert tp.generate_to_file(a, out, steps=2, seed=1) == out
    wav, _ = tp.generate(a, steps=2, seed=1)
    audio, sr = read_wav(str(tmp_path / "out" / "a.generated.wav"))
    assert sr == 24_000 and audio.shape == (1, len(wav))
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(audio[0], pcm / np.float32(32768.0))
