"""The port's other video towers against the JAX package's, on the CPU in
float32, with the JAX towers' weights carried across: CLIP ViT-L/14-336
(its quick-GELU miniature), DINOv2 and ConvNeXt features; the full-width
configs' parameter names and shapes; the PIL-exact host resize; every
``video_encoder`` mode of ``V2APipeline`` (features, sampled latents and the
waveform of ``generate`` from JAX's x0) and ``TrainingPipeline.device_batch``
in the mixed mode.

Tolerances: tower features atol 1e-5 (tiny f32 towers, another summation
order); latents and waveforms 1e-4 relative RMS (as the serving tests);
resized frames exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_pipeline import write_synthetic_video
from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch import config as t_config
from v2ap_torch.data import dataset as t_dataset
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.models import convnext as t_convnext
from v2ap_torch.models import dinov2 as t_dinov2
from v2ap_torch.models import t5 as t_t5
from v2ap_torch.models import video_towers as t_towers
from v2ap_torch.pipelines import generate as t_generate
from v2ap_torch.training import pipeline as t_training
from v2ap_torch.utils.convert import _target, load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.config import SamplerConfig
from v2ap_tpu.models import clip_vit as j_clip
from v2ap_tpu.models import convnext as j_convnext
from v2ap_tpu.models import dinov2 as j_dinov2
from v2ap_tpu.models import video_towers as j_towers
from v2ap_tpu.models.t5 import t5_tiny_test
from v2ap_tpu.pipelines import generate as j_generate

torch.set_num_threads(2)

TARGET = 48                         # latents per training window
MODES = ("clip_vit", "clip_vit2", "clip_convnext", "dinov2", "mixed")


def _clip_l_tiny(mod):
    """The quick-GELU ViT-L miniature of the JAX package's mode test."""
    return mod.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_layers=1, num_heads=4,
        image_size=28, patch_size=14, projection_dim=12,
        hidden_act="quick_gelu", dtype="float32")


def _tiny_towers(clip, convnext, dinov2):
    return {"clip_vit": clip.clip_tiny_test(),            # projection 16
            "clip_vit2": _clip_l_tiny(clip),               # projection 12
            "clip_convnext": convnext.convnext_tiny_test(),  # embed 24
            "dinov2": dinov2.dinov2_tiny_test()}           # hidden 32


J_TOWERS = _tiny_towers(j_clip, j_convnext, j_dinov2)
T_TOWERS = _tiny_towers(t_clip, t_convnext, t_dinov2)
DIMS = {"clip_vit": 16, "clip_vit2": 12, "clip_convnext": 24, "dinov2": 32}

# tower name -> (JAX model class, port model class)
TOWERS = {
    "clip_vit2": (j_clip.CLIPVisionModel, t_clip.CLIPVisionModel),
    "dinov2": (j_dinov2.Dinov2Model, t_dinov2.Dinov2Model),
    "clip_convnext": (j_convnext.ConvNextCLIP, t_convnext.ConvNextCLIP),
}


def _tower_pair(name, seed):
    j_build, t_build = TOWERS[name]
    jm = j_build(J_TOWERS[name], rngs=nnx.Rngs(seed))
    randomize_jax(jm, seed, scale=0.1)
    tm = t_build(T_TOWERS[name], device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_features_match_jax(name):
    """Each new tower on seeded normalised pixels at its own image size:
    (b, embed_dim) float32 features within 1e-5 of JAX's."""
    jm, tm = _tower_pair(name, 3)
    size = J_TOWERS[name].image_size
    px = np.random.default_rng(4).normal(size=(3, size, size, 3)
                                         ).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(px)))
    with torch.no_grad():
        got = tm(T(px))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (3, DIMS[name])
    np.testing.assert_allclose(N(got), want, atol=1e-5, rtol=0)


def test_convnext_pooled_matches_jax():
    """ConvNeXt's trunk output before the projection head (HF's
    ``pooler_output``)."""
    jm, tm = _tower_pair("clip_convnext", 5)
    px = np.random.default_rng(6).normal(size=(2, 32, 32, 3)
                                         ).astype(np.float32)
    with torch.no_grad():
        got = tm.pooled(T(px))
    np.testing.assert_allclose(N(got), np.asarray(jm.pooled(jnp.asarray(px))),
                               atol=1e-5, rtol=0)


def test_dinov2_mlp_variant_matches_jax():
    """DINOv2 with the GELU MLP of the base / large variants
    (``use_swiglu_ffn=False``) and LayerScale away from 1."""
    cfg = dataclasses.replace(j_dinov2.dinov2_tiny_test(),
                              use_swiglu_ffn=False, layerscale_value=0.5)
    jm = j_dinov2.Dinov2Model(cfg, rngs=nnx.Rngs(7))
    tm = t_dinov2.Dinov2Model(t_dinov2.Dinov2Config(**dataclasses.asdict(cfg)),
                              device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    px = np.random.default_rng(8).normal(size=(2, 28, 28, 3)
                                         ).astype(np.float32)
    with torch.no_grad():
        got = tm(T(px))
    np.testing.assert_allclose(N(got), np.asarray(jm(jnp.asarray(px))),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,j_cfg,t_cfg", [
    ("clip_vit2", j_clip.clip_vit_l_336, t_clip.clip_vit_l_336),
    ("dinov2", j_dinov2.dinov2_giant, t_dinov2.dinov2_giant),
    ("clip_convnext", j_convnext.convnext_xxlarge, t_convnext.convnext_xxlarge),
], ids=["clip_vit_l_336", "dinov2_giant", "convnext_xxlarge"])
def test_full_width_towers_have_jax_parameters(name, j_cfg, t_cfg):
    """The full-width configs equal JAX's field by field, and every
    parameter of the JAX tower (built abstractly) has its place and shape in
    the port's (built on the meta device), and no port tensor is left
    over: ViT-L/336 (24 x 1024, 577 tokens), DINOv2-giant (40 x 1536,
    SwiGLU hidden 4096), ConvNeXt-XXLarge ((3, 4, 30, 3) blocks)."""
    assert dataclasses.asdict(j_cfg()) == dataclasses.asdict(t_cfg())
    j_build, t_build = TOWERS[name]
    abstract = nnx.eval_shape(lambda: j_build(j_cfg(), rngs=nnx.Rngs(0)))
    shapes = {".".join(map(str, path)): tuple(v.shape) for path, v in
              nnx.to_flat_state(nnx.state(abstract, nnx.Param))}
    tm = t_build(t_cfg(), device="meta")
    tensors = dict(tm.named_parameters())
    placed = set()
    for key, shape in shapes.items():
        target, transform = _target(tm, key)
        want = transform(np.broadcast_to(np.float32(0), shape)).shape
        assert tuple(tensors[target].shape) == want, key
        placed.add(target)
    assert placed == set(tensors)
    if name == "dinov2":
        assert t_cfg().swiglu_hidden == 4096


@pytest.mark.parametrize("shape,size", [
    ((28, 28), 32), ((224, 224), 336), ((224, 224), 256), ((336, 336), 224),
    ((48, 64), 28), ((100, 60), 44), ((1080, 1920), 224), ((7, 9), 28)],
    ids=["28to32", "224to336", "224to256", "336to224", "48x64to28",
         "100x60to44", "1080pto224", "7x9to28"])
def test_resize_equals_jax_preprocessing(shape, size):
    """The port's tower geometry (``crop_to_tower``, no PIL) against the
    JAX package's ``preprocess_frames(normalize=False)`` (PIL, or its native
    resampler): bit-equal uint8; then ``device_normalize`` of it against
    JAX's normalised floats."""
    frames = np.random.default_rng(9).integers(0, 256, (3,) + shape + (3,),
                                               dtype=np.uint8)
    frames[0, : shape[0] // 2] = 255                  # hard edges: clipping
    frames[0, shape[0] // 2:] = 0
    px = t_clip.crop_to_tower(torch.from_numpy(frames), size)
    want = j_clip.preprocess_frames(frames, size, normalize=False)
    assert px.dtype == torch.uint8 and px.shape == (3, size, size, 3)
    np.testing.assert_array_equal(N(px), want)
    np.testing.assert_allclose(
        N(t_clip.device_normalize(px, t_dinov2.IMAGENET_MEAN,
                                  t_dinov2.IMAGENET_STD)),
        j_clip.preprocess_frames(frames, size, mean=j_dinov2.IMAGENET_MEAN,
                                 std=j_dinov2.IMAGENET_STD), atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_build_video_towers_matches_jax(mode):
    """Every mode builds the JAX package's tower list: names, widths,
    image sizes and normalisation constants; the mixed width is the sum."""
    jt = j_towers.build_video_towers(mode, seed=0, overrides=J_TOWERS)
    tt = t_towers.build_video_towers(mode, seed=0, overrides=T_TOWERS,
                                     device="cpu")
    assert [t.name for t in tt] == [t.name for t in jt]
    for a, b in zip(tt, jt):
        assert (a.embed_dim, a.mean, a.std) == (b.embed_dim, b.mean, b.std)
        assert a.model.cfg.image_size == b.model.cfg.image_size
    assert t_towers.VALID_ENCODERS == j_towers.VALID_ENCODERS
    assert t_towers.mixed_embed_dim(T_TOWERS) == \
        j_towers.mixed_embed_dim(J_TOWERS) == 84
    assert t_towers.mixed_embed_dim() == j_towers.mixed_embed_dim() == 4608


def test_build_video_towers_refuses_unknown_mode():
    with pytest.raises(ValueError, match="not one of"):
        t_towers.build_video_towers("clip_vit3", device="cpu")


def _cfg(mod, mode):
    """tiny_test with the test towers' widths: the text stream 16 wide,
    ``dim_text_raw`` the mode's tower width where it is not 16 (the mixed
    84 through ``proj_text``), frame stride 1, no feature caches."""
    cfg = mod.tiny_test()
    tdim = sum(DIMS.values()) if mode == "mixed" else DIMS[mode]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dim_text=16, dim_context=32,
                                  num_channels=8,
                                  dim_text_raw=tdim if tdim != 16 else None),
        conditioning=dataclasses.replace(cfg.conditioning, video_encoder=mode,
                                         frame_stride=1, strip_stride=1,
                                         feature_cache=False))


def _pipelines(mode):
    jp = j_generate.V2APipeline(_cfg(j_config, mode),
                                t5_config=t5_tiny_test(),
                                tower_configs=J_TOWERS, quantize_towers=False)
    models = [jp.cfm, jp.codec, jp.t5] + [t.model for t in jp.towers]
    for i, model in enumerate(models):
        randomize_jax(model, 30 + i, scale=0.05)
    tp = t_generate.V2APipeline(_cfg(t_config, mode), device="cpu",
                                t5_config=t_t5.t5_tiny_test(),
                                tower_configs=T_TOWERS, quantize_towers=False)
    for a, b in ((tp.cfm, jp.cfm), (tp.codec, jp.codec), (tp.t5, jp.t5)):
        load_jax_params(a, flatten_jax(b))
    for a, b in zip(tp.towers, jp.towers):
        load_jax_params(a.model, flatten_jax(b.model))
    return jp, tp


@pytest.mark.parametrize("mode", MODES)
def test_generate_in_every_mode_matches_jax(mode, monkeypatch, tmp_path):
    """Each mode from the same 28x28 frames handed in through
    ``frames_cache`` (ConvNeXt resizes them to 32): the features at the
    latent rate (atol 1e-5) and ``CFM.sample`` with CFG from one x0 on them
    (latents 1e-4 rel-RMS); then ``generate`` of a 64x48 mp4 that each
    package decodes, every tower resizing its frames, with JAX's x0 for the
    seed (waveform 1e-4 rel-RMS)."""
    jp, tp = _pipelines(mode)
    tdim = sum(DIMS.values()) if mode == "mixed" else DIMS[mode]
    assert jp.video_embed_dim == tp.video_embed_dim == tdim
    frames = np.random.default_rng(10).integers(0, 256, (12, 28, 28, 3),
                                                dtype=np.uint8)
    n, n_valid = 96, 75
    feats_j, _ = jp.encode_video_frames_clip(
        "clip.mp4", n, frames_cache=[(frames, 1.0, 1)])
    feats_t, _ = tp.encode_video_frames_clip(
        "clip.mp4", n, frames_cache=[(frames, 1.0, 1)])
    assert feats_t.shape == (n, tdim)
    assert set(tp.tower_seconds) == {t.name for t in tp.towers}
    np.testing.assert_allclose(N(feats_t), np.asarray(feats_j), atol=1e-5,
                               rtol=0)

    cfg = jp.cfg.model
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=(1, n, cfg.num_channels)).astype(np.float32)
    roll = np.zeros((1, n, cfg.notes), np.float32)
    ctx = np.zeros((1, 1, cfg.dim_context), np.float32)
    cmask = np.ones((1, 1), bool)
    mask = np.arange(n)[None, :] < n_valid
    lat_j = jp._sample(jp.cfm, x0, np.asarray(feats_j)[None], roll, ctx,
                       cmask, mask, SamplerConfig(steps=3, cfg_strength=2.0))
    with torch.no_grad():
        lat_t = tp.cfm.sample(
            T(x0), text_embed=feats_t[None], frames_embed=T(roll),
            context=T(ctx), context_mask=T(cmask), mask=T(mask),
            sampler=t_config.SamplerConfig(steps=3, cfg_strength=2.0))
    assert rel_rms(N(lat_t), lat_j) < 1e-4

    seed = 2

    def jax_x0(s, shape):
        assert s == seed
        return T(np.asarray(jax.random.normal(jax.random.key(s), shape)))

    monkeypatch.setattr(tp, "_normal", jax_x0)
    video = str(tmp_path / "clip.mp4")
    assert write_synthetic_video(video, frames=10, fps=10)   # 64x48, 1 s
    want, _ = jp.generate(video, steps=2, seed=seed)
    got, sr = tp.generate(video, steps=2, seed=seed)
    assert sr == 24_000 and got.shape == want.shape == (24_000,)
    assert np.isfinite(got).all()
    assert rel_rms(got, want) < 1e-4


def test_mixed_device_batch_matches_jax(tmp_path, monkeypatch):
    """``TrainingPipeline.device_batch`` in the mixed mode (the four tiny
    towers, dim_text_raw 84) on a synthetic 64x48 mp4 decoded by each
    package: the concatenated features at the latent rate within 1e-5 of
    JAX's. Both training pipelines get the towers' configs through their
    serving pipeline's ``tower_configs``, which neither constructor takes."""
    from v2ap_tpu.pipelines import generate as j_gen_mod
    from v2ap_tpu.training.pipeline import TrainingPipeline as JTP

    video = str(tmp_path / "clip.mp4")
    if not write_synthetic_video(video, frames=30, fps=25):
        pytest.skip("no video writer available")

    def cfg(mod):
        c = _cfg(mod, "mixed")
        return c.replace(data=dataclasses.replace(
            c.data, target_length=TARGET, min_target_length=TARGET))

    monkeypatch.setattr(j_gen_mod, "V2APipeline", functools.partial(
        j_gen_mod.V2APipeline, tower_configs=J_TOWERS))
    monkeypatch.setattr(t_training, "V2APipeline", functools.partial(
        t_generate.V2APipeline, tower_configs=T_TOWERS))
    jp = JTP(cfg(j_config), work_dir=str(tmp_path / "j"), seed=0,
             t5_config=t5_tiny_test())
    tp = t_training.TrainingPipeline(cfg(t_config), work_dir=str(tmp_path / "t"),
                                     seed=0, t5_config=t_t5.t5_tiny_test(),
                                     device="cpu")
    for a, b in zip(tp.pipe.towers, jp.pipe.towers):
        randomize_jax(b.model, 40, scale=0.1)
        load_jax_params(a.model, flatten_jax(b.model))
    rng = np.random.default_rng(12)
    batch = t_dataset.Batch(
        waveforms=(rng.normal(size=(2, TARGET * 320)) * 0.2
                   ).astype(np.float32),
        lens=np.full((2,), TARGET, np.int32), captions=["rain", ""],
        video_paths=[video, None], piano=[False, False],
        video_drop_prompt=np.zeros(2, bool),
        audio_drop_prompt=np.zeros(2, bool))
    want = np.asarray(jp.device_batch(batch)["text_embed"])
    got = N(tp.device_batch(batch)["text_embed"])
    assert got.shape == want.shape == (2, TARGET, 84)
    assert got[0].any() and not got[1].any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
