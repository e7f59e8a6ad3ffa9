"""Parity of the PyTorch port's models (transformer, CFM sampler, EnCodec
decoder, CLIP tower), host helpers and weight converter with the JAX
package's, on the CPU.

Weights are the JAX model's (randomised where its init is zero, so every
projection is exercised) carried across by ``load_jax_params``; inputs and
the sampler's x0 come from numpy with a fixed seed. Whole-model outputs are
compared by relative RMS error, bounded at 1e-4 in float32: a transformer
eval sums many float32 matmuls whose summation order differs between XLA and
PyTorch, which moves outputs by ~1e-6 relative per layer.
"""

import dataclasses

import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_ops import N, T, flatten_jax, port_weights, randomize_jax
from v2ap_torch import config as t_config
from v2ap_torch.data import video_io as t_video_io
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.models import encodec as t_encodec
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.data import video_io as j_video_io
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.models import clip_vit as j_clip
from v2ap_tpu.models import encodec as j_encodec

torch.set_num_threads(2)

REL_RMS = 1e-4


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def model_cfgs(**kw):
    """The tiny model config, as the JAX and the port config classes."""
    j = dataclasses.replace(j_config.tiny_test().model, **kw)
    t = dataclasses.replace(t_config.tiny_test().model, **kw)
    return j, t


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("name", ["v2a_default", "tiny_test", "v2p_88key"])
def test_config_matches_jax(name):
    """The port's copy of the configuration: the same fields and values, so
    one configuration drives both packages."""
    from v2ap_torch.models import t5 as t_t5
    from v2ap_tpu.models import t5 as j_t5

    j, t = getattr(j_config, name)(), getattr(t_config, name)()
    for section in ("model", "sampler", "conditioning"):
        assert dataclasses.asdict(getattr(t, section)) == \
            dataclasses.asdict(getattr(j, section)), section
    for mod_t, mod_j, fns in (
            (t_clip, j_clip, ("clip_vit_bigg", "clip_tiny_test")),
            (t_t5, j_t5, ("flan_t5_large", "t5_tiny_test"))):
        for fn in fns:
            assert dataclasses.asdict(getattr(mod_t, fn)()) == \
                dataclasses.asdict(getattr(mod_j, fn)())
    assert dataclasses.asdict(t_encodec.EncodecConfig()) == \
        dataclasses.asdict(j_encodec.EncodecConfig())


# ------------------------------------------------------- transformer / CFM

@pytest.fixture(scope="module")
def cfm_pair():
    """One tiny JAX CFM with randomised weights and its port. dim_context
    equals dim, so the same model takes a prompt context and, without one,
    runs its cross-attention as rotary self-attention."""
    jcfg, tcfg = model_cfgs(dim_context=64)
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(0))
    randomize_jax(jm, 1, scale=0.05)
    flat = flatten_jax(jm)
    tm = t_cfm.CFM(tcfg, device="cpu")
    load_jax_params(tm, flat)
    return jm, tm, jcfg, flat


_j_transformer = nnx.jit(
    lambda m, x, times, mask, text, frames, ctx, cmask: m(
        x, times=times, mask=mask, text_embed=text, frames_embed=frames,
        context=ctx, context_mask=cmask))


@pytest.mark.parametrize("kind", ["context", "no_context_self_attn"])
def test_transformer_matches_jax(cfm_pair, kind):
    """One TriStreamTransformer eval, with a masked prompt context, and
    without one (cross-attention as rotary self-attention)."""
    jm, tm, cfg, _ = cfm_pair
    rng = np.random.default_rng(0)
    b, n = 2, 21
    x = rng.normal(size=(b, n, cfg.dim)).astype(np.float32)
    text = rng.normal(size=(b, n, cfg.dim_text)).astype(np.float32)
    frames = rng.normal(size=(b, n, cfg.dim_frames)).astype(np.float32)
    times = np.array([0.1, 0.8], np.float32)
    mask = np.arange(n)[None, :].repeat(b, 0) < np.array([[n], [15]])
    ctx = cmask = None
    if kind == "context":
        ctx = rng.normal(size=(b, 3, cfg.dim_context)).astype(np.float32)
        cmask = np.array([[True] * 3, [True, True, False]])
    ref = _j_transformer(jm.transformer, x, times, mask, text, frames, ctx,
                         cmask)
    with torch.no_grad():
        out = tm.transformer(
            T(x), times=T(times), mask=T(mask), text_embed=T(text),
            frames_embed=T(frames), context=None if ctx is None else T(ctx),
            context_mask=None if cmask is None else T(cmask))
        # the per-norm projections give the fused matmul's result
        tm.transformer.cfg = dataclasses.replace(cfg, fused_adaln=False)
        try:
            unfused = tm.transformer(
                T(x), times=T(times), mask=T(mask), text_embed=T(text),
                frames_embed=T(frames),
                context=None if ctx is None else T(ctx),
                context_mask=None if cmask is None else T(cmask))
        finally:
            tm.transformer.cfg = cfg
    assert rel_rms(N(out), ref) < REL_RMS
    assert rel_rms(N(unfused), N(out)) < 1e-5


_j_sample = nnx.jit(
    lambda m, x0, text, roll, ctx, cmask, mask, sampler: m.sample(
        x0, text_embed=text, frames_embed=roll, context=ctx,
        context_mask=cmask, mask=mask, sampler=sampler),
    static_argnames="sampler")


@pytest.mark.parametrize("sampler_kw", [
    dict(steps=4, cfg_strength=2.0),                       # the serving CFG
    dict(steps=4, cfg_strength=0.0, sway_sampling=False),  # fewstep mode
    dict(steps=3, cfg_strength=2.0, method="midpoint",
         remove_parallel_component=True, keep_parallel_frac=0.3),
], ids=["cfg", "fewstep", "midpoint_parallel"])
def test_cfm_sample_matches_jax(cfm_pair, sampler_kw):
    """CFM.sample with CFG folded into the batch-doubled forward, from the
    same x0, text stream, zero roll and zero length-1 context (the V2A
    empty-prompt inputs)."""
    jm, tm, cfg, _ = cfm_pair
    rng = np.random.default_rng(2)
    b, n = 1, 24
    x0 = rng.normal(size=(b, n, cfg.num_channels)).astype(np.float32)
    text = rng.normal(size=(b, n, cfg.dim_text)).astype(np.float32)
    roll = np.zeros((b, n, cfg.notes), np.float32)
    ctx = np.zeros((b, 1, cfg.dim_context), np.float32)
    cmask = np.ones((b, 1), bool)
    mask = np.arange(n)[None, :] < 20
    ref = _j_sample(jm, x0, text, roll, ctx, cmask, mask,
                    j_config.SamplerConfig(**sampler_kw))
    with torch.no_grad():
        out = tm.sample(T(x0), text_embed=T(text), frames_embed=T(roll),
                        context=T(ctx), context_mask=T(cmask), mask=T(mask),
                        sampler=t_config.SamplerConfig(**sampler_kw))
    assert out.dtype == torch.float32
    assert rel_rms(N(out), ref) < REL_RMS


def test_cfm_sample_infill_and_dropped_prompt_matches_jax(cfm_pair):
    """The rest of sample's signature: an audio infill condition held fixed
    where cond_mask is set, a prompt context dropped for one batch row, and
    a nonzero roll stream (kept in the CFG null branch)."""
    jm, tm, cfg, _ = cfm_pair
    rng = np.random.default_rng(3)
    b, n = 2, 16
    x0, cond = (rng.normal(size=(b, n, cfg.num_channels)).astype(np.float32)
                for _ in range(2))
    text = rng.normal(size=(b, n, cfg.dim_text)).astype(np.float32)
    roll = rng.random((b, n, cfg.notes)).astype(np.float32)
    ctx = rng.normal(size=(b, 3, cfg.dim_context)).astype(np.float32)
    cmask = np.array([[True] * 3, [True, True, False]])
    mask = np.ones((b, n), bool)
    cond_mask = np.arange(n)[None, :].repeat(b, 0) < 6
    drop = np.array([False, True])
    kw = dict(steps=3, cfg_strength=2.0)
    ref = nnx.jit(lambda m: m.sample(
        x0, text_embed=text, frames_embed=roll, context=ctx,
        context_mask=cmask, mask=mask, sampler=j_config.SamplerConfig(**kw),
        cond=cond, cond_mask=cond_mask, drop_prompt=drop))(jm)
    with torch.no_grad():
        out = tm.sample(T(x0), text_embed=T(text), frames_embed=T(roll),
                        context=T(ctx), context_mask=T(cmask), mask=T(mask),
                        sampler=t_config.SamplerConfig(**kw), cond=T(cond),
                        cond_mask=T(cond_mask), drop_prompt=T(drop))
    np.testing.assert_array_equal(N(out)[:, :6], cond[:, :6])
    assert rel_rms(N(out), ref) < REL_RMS


@pytest.mark.parametrize("variant", [dict(concat_cond=True),
                                     dict(dim_text_raw=24)],
                         ids=["concat_cond", "dim_text_raw"])
def test_cfm_pred_head_variants_match_jax(variant):
    """pred_head's other input projections: the infill condition
    concatenated to the latents, and a raw text width projected to
    dim_text."""
    jcfg, tcfg = model_cfgs(depth=2, text_depth=2, **variant)
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(5))
    randomize_jax(jm, 6, scale=0.05)
    tm = port_weights(jm, t_cfm.CFM(tcfg, device="cpu"))
    rng = np.random.default_rng(6)
    b, n = 2, 10
    x, cond = (rng.normal(size=(b, n, jcfg.num_channels)).astype(np.float32)
               for _ in range(2))
    text = rng.normal(size=(b, n, jcfg.dim_text_raw or jcfg.dim_text)
                      ).astype(np.float32)
    roll = rng.random((b, n, jcfg.notes)).astype(np.float32)
    ctx = rng.normal(size=(b, 2, jcfg.dim_context)).astype(np.float32)
    times = np.array([0.2, 0.9], np.float32)
    mask, cmask = np.ones((b, n), bool), np.ones((b, 2), bool)
    ref = nnx.jit(lambda m: m.pred_head(
        x, cond, times=times, mask=mask, text_embed=text, frames_embed=roll,
        context=ctx, context_mask=cmask))(jm)
    with torch.no_grad():
        out = tm.pred_head(T(x), T(cond), times=T(times), mask=T(mask),
                           text_embed=T(text), frames_embed=T(roll),
                           context=T(ctx), context_mask=T(cmask))
    assert rel_rms(N(out), np.asarray(ref)) < REL_RMS


def test_cfm_bfloat16_pred_head_tracks_jax():
    """The compute dtype bf16 on both sides: rounding points differ between
    nnx and the port (e.g. bias added before vs after the output rounding),
    so this bound is loose — 3e-2 rel-RMS, ~4 bf16 ulps — and catches a
    missing cast, not rounding."""
    jcfg, tcfg = model_cfgs(dtype="bfloat16", depth=2, text_depth=2)
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(3))
    randomize_jax(jm, 4, scale=0.05)
    tm = port_weights(jm, t_cfm.CFM(tcfg, device="cpu"))
    rng = np.random.default_rng(4)
    b, n = 2, 16
    x = rng.normal(size=(b, n, jcfg.num_channels)).astype(np.float32)
    text = rng.normal(size=(b, n, jcfg.dim_text)).astype(np.float32)
    roll = rng.random((b, n, jcfg.notes)).astype(np.float32)
    ctx = np.zeros((b, 1, jcfg.dim_context), np.float32)
    times = np.array([0.3, 0.6], np.float32)
    mask = np.ones((b, n), bool)
    cmask = np.ones((b, 1), bool)
    ref = nnx.jit(lambda m: m.pred_head(
        x, None, times=times, mask=mask, text_embed=text, frames_embed=roll,
        context=ctx, context_mask=cmask))(jm)
    with torch.no_grad():
        out = tm.pred_head(T(x), None, times=T(times), mask=T(mask),
                           text_embed=T(text), frames_embed=T(roll),
                           context=T(ctx), context_mask=T(cmask))
    assert out.dtype == torch.float32
    assert rel_rms(N(out), np.asarray(ref)) < 3e-2


# ----------------------------------------------------------------- EnCodec

def test_encodec_decode_matches_jax():
    """Latents -> waveform through the full 24 kHz codec's causal conv /
    transposed-conv / LSTM stack (the pipeline test covers the miniature
    codec)."""
    jcfg = j_encodec.EncodecConfig()
    jm = j_encodec.EncodecModel(jcfg, rngs=nnx.Rngs(0))
    tm = t_encodec.EncodecModel(t_encodec.EncodecConfig(), device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    lat = np.random.default_rng(5).normal(
        size=(2, 11, jcfg.hidden_size)).astype(np.float32)
    ref = np.asarray(nnx.jit(lambda m, z: m.decode(z))(jm, lat))
    with torch.no_grad():
        out = N(tm.decode(T(lat)))
    assert out.shape == ref.shape == (2, 11 * 320)
    assert rel_rms(out, ref) < REL_RMS


def test_causal_conv_transpose_matches_jax():
    """The transposed conv alone (no kernel flip: lax.conv_transpose with
    transpose_kernel=True is torch's conv_transpose1d), at atol 1e-5."""
    jcfg = j_encodec.EncodecConfig()
    jc = j_encodec.CausalConvTranspose1d(jcfg, 6, 4, 10, stride=5,
                                         rngs=nnx.Rngs(0))
    randomize_jax(jc, 6, scale=0.3)
    tc = port_weights(jc, t_encodec.CausalConvTranspose1d(
        t_encodec.EncodecConfig(), 6, 4, 10, stride=5))
    x = np.random.default_rng(7).normal(size=(2, 9, 6)).astype(np.float32)
    ref = np.asarray(jc(x))                                     # (b, t, c)
    with torch.no_grad():
        out = N(tc(T(x).transpose(1, 2))).transpose(0, 2, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------------- CLIP

@pytest.mark.parametrize("clip", ["tiny", "d104"])
def test_clip_matches_jax(clip):
    """Pixels -> projected embeds. "d104" has bigG's head width (104) on a
    small tower."""
    kw = {} if clip == "tiny" else dict(hidden_size=208, num_heads=2,
                                        num_layers=1)
    jcfg = dataclasses.replace(j_clip.clip_tiny_test(), **kw)
    tcfg = dataclasses.replace(t_clip.clip_tiny_test(), **kw)
    jm = j_clip.CLIPVisionModel(jcfg, rngs=nnx.Rngs(0))
    randomize_jax(jm, 8, scale=0.05)
    tm = port_weights(jm, t_clip.CLIPVisionModel(tcfg, device="cpu"))
    px = np.random.default_rng(9).normal(size=(3, 28, 28, 3)).astype(np.float32)
    ref = np.asarray(nnx.jit(lambda m, p: m(p))(jm, px))
    with torch.no_grad():
        out = N(tm(T(px)))
    assert out.shape == (3, 16)
    assert rel_rms(out, ref) < REL_RMS


def test_clip_preprocess_matches_jax():
    """Geometry (``crop_to_tower``): frames already at the tower's size
    pass through unchanged; other sizes resize and crop as the JAX package
    does (exact uint8); normalisation (``device_normalize``) to 1e-6."""
    rng = np.random.default_rng(10)
    square = rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8)
    out = N(t_clip.crop_to_tower(torch.from_numpy(square), 28))
    np.testing.assert_array_equal(out, square)
    np.testing.assert_array_equal(
        out, j_clip.preprocess_frames(square, 28, normalize=False))
    wide = rng.integers(0, 256, (2, 30, 44, 3), dtype=np.uint8)
    px = t_clip.crop_to_tower(torch.from_numpy(wide), 28)
    np.testing.assert_array_equal(
        N(px), j_clip.preprocess_frames(wide, 28, normalize=False))
    np.testing.assert_allclose(
        N(t_clip.device_normalize(px, t_clip.CLIP_MEAN, t_clip.CLIP_STD)),
        j_clip.preprocess_frames(wide, 28), atol=1e-6)
    norm = t_clip.device_normalize(torch.from_numpy(square), t_clip.CLIP_MEAN,
                                   t_clip.CLIP_STD)
    np.testing.assert_allclose(
        N(norm), np.asarray(j_clip.device_normalize(
            square, j_clip.CLIP_MEAN, j_clip.CLIP_STD)), atol=1e-6)


# ---------------------------------------------------------------- video IO

def test_video_io_matches_jax(tmp_path):
    for args in [(250, 10.0, 2250), (12, 1.0, 96), (7, 0.3, 40)]:
        np.testing.assert_array_equal(
            t_video_io.interp_indices_clip(*args),
            j_video_io.interp_indices_clip(*args))
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 4, (32, 24))
    rng = np.random.default_rng(11)
    for _ in range(9):
        writer.write(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    writer.release()
    assert t_video_io.probe_duration(path) == j_video_io.probe_duration(path)
    for step in (1, 3):
        f_t, d_t = t_video_io.read_video_frames(path, step=step)
        f_j, d_j = j_video_io.read_video_frames(path, step=step)
        np.testing.assert_array_equal(f_t, f_j)
        assert d_t == d_j
    assert t_video_io.read_video_frames(str(tmp_path / "missing.mp4")) == \
        (None, None)


# --------------------------------------------------------------- converter

def test_load_jax_params_rejects_unknown_and_missing_keys(cfm_pair):
    _, tm, _, flat = cfm_pair
    # every JAX module is ported: a codec key has no place in a CFM
    with pytest.raises(KeyError, match="no place"):
        load_jax_params(tm, {**flat, "encoder.conv1.kernel": np.zeros(3)})
    # Video2Roll is ported: its keys need a CFM built with it
    with pytest.raises(KeyError, match="no place"):
        load_jax_params(tm, {**flat, "video2roll.fc.kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="no place"):
        load_jax_params(tm, {**flat, "transformer.bogus.kernel": np.zeros(1)})
    short = dict(flat)
    del short["transformer.time_mlp.fourier.weights"]
    with pytest.raises(KeyError, match="not filled"):
        load_jax_params(tm, short)
    bad = dict(flat)
    bad["proj_in.kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_params(tm, bad)


def test_entry_points_refuse_missing_cuda():
    """device=None means CUDA; without a card the port raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = model_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cfm.CFM(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_encodec.EncodecModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_clip.CLIPVisionModel(t_clip.clip_tiny_test())
    # the models a caller may build on their own: the transformer defaulted
    # to the CPU before (ROADMAP section 3)
    from v2ap_torch.models.t5 import T5Encoder, t5_tiny_test
    from v2ap_torch.models.transformer import TriStreamTransformer
    from v2ap_torch.models.video2roll import Video2RollNet
    for build in (lambda: TriStreamTransformer(tcfg),
                  lambda: T5Encoder(t5_tiny_test()), Video2RollNet):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
