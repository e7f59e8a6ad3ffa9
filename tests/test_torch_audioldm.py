"""The port's AudioLDM baseline against the JAX package's, on the CPU in
float32: ``models/latent_diffusion.py`` (timestep embedding, schedules,
``UNet2D``, ``q_sample`` / ``loss`` / ``ddim_sample``,
``AudioLDMBackend.text_to_audio``), ``models/audioldm_vae.py``
(``AudioLDMVAE``, ``VaeVocoder``), ``models/hifigan.py``, the UNet's
state-dict reader and ``python -m v2ap_torch.convert --audioldm``.

Weights are JAX's, randomised so that the zero-initialised convolutions
take part, carried across by ``load_jax_params``; JAX's random draws (the
DDIM noise from its key chain, the VAE's posterior noise, ``x_t``) are
reproduced here and handed in, transposed from NHWC to the port's NCHW.

Tolerances: the schedules exactly equal (float64 tables rounded to JAX's
float32); the timestep embedding within 1e-5 (see its test); each module
within 1e-5
relative RMS; whole paths (DDIM, text_to_audio, VaeVocoder) within 1e-4
relative RMS; readers bit-equal.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch.models import audioldm_vae as t_vae
from v2ap_torch.models import clap as t_clap
from v2ap_torch.models import hifigan as t_hifi
from v2ap_torch.models import latent_diffusion as t_ldm
from v2ap_torch.utils import torch_convert as t_tc
from v2ap_torch.utils.convert import _target, load_jax_params
from v2ap_tpu.models import audioldm_vae as j_vae
from v2ap_tpu.models import clap as j_clap
from v2ap_tpu.models import hifigan as j_hifi
from v2ap_tpu.models import latent_diffusion as j_ldm
from v2ap_tpu.utils import torch_convert as j_tc

torch.set_num_threads(2)

MODULE_REL_RMS = 1e-5
PATH_REL_RMS = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "model.diffusion_model."


def nchw(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def nhwc(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 2, 3, 1)


def port_of(jm, tm, seed: int, scale: float = 0.05):
    randomize_jax(jm, seed, scale=scale)
    load_jax_params(tm, flatten_jax(jm))
    return tm


# ---------------------------------------------------------------- schedules

def test_timestep_embedding_matches_jax():
    """Within 1e-5 relative RMS, and elementwise within two float32 ulps
    of the largest argument (999 * 2^-22 = 2.4e-4): XLA's and PyTorch's
    float32 ``exp`` may round a frequency one ulp apart, which moves an
    argument of up to 999 rad by up to 999 * 2^-23."""
    t = np.array([0, 1, 7, 250, 999], np.int32)
    for dim in (16, 33, 128):
        want = np.asarray(j_ldm.timestep_embedding(jnp.asarray(t), dim))
        got = N(t_ldm.timestep_embedding(T(t), dim))
        assert got.shape == want.shape == (5, dim)
        np.testing.assert_allclose(got, want, atol=999 * 2.0 ** -22, rtol=0)
        assert rel_rms(got, want) < MODULE_REL_RMS


@pytest.mark.parametrize("steps", [25, 7, 200, 1000, 2000, 333],
                         ids=["divides", "ragged", "stride5", "every",
                              "clamped", "stride3"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_schedules_equal_jax(steps, eta):
    """The betas exactly; the DDIM table in float64, rounded, equal to JAX's
    float32 table, including a step count that does not divide the
    timesteps (7 -> stride 142 -> 8 rows). A stride that divides 999
    (1000, 2000 -> 1; 333 -> 3) reaches timestep 1000, past the 1000-row
    table: both packages raise there, as the reference's uniform
    schedule does."""
    for cfg in (t_ldm.ldm_s_full(), t_ldm.ldm_tiny_test()):
        np.testing.assert_array_equal(t_ldm.make_betas(cfg),
                                      j_ldm.make_betas(cfg))
    cfg = t_ldm.ldm_s_full()
    if 999 % max(1, cfg.timesteps // steps) == 0:
        with pytest.raises(IndexError):
            j_ldm.make_ddim_schedule(cfg, steps, eta)
        with pytest.raises(IndexError):
            t_ldm.make_ddim_schedule(cfg, steps, eta)
        return
    got = t_ldm.make_ddim_schedule(cfg, steps, eta)
    want = np.asarray(j_ldm.make_ddim_schedule(cfg, steps, eta))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.astype(np.float32), want)
    assert len(got) == -(-cfg.timesteps // max(1, cfg.timesteps // steps))


# --------------------------------------------------------------------- UNet

def _cfg(film: bool):
    if film:
        return j_ldm.ldm_tiny_test()
    return j_ldm.LDMConfig(in_channels=4, out_channels=4, model_channels=16,
                           num_res_blocks=1, attention_resolutions=(2,),
                           channel_mult=(1, 2), num_head_channels=8,
                           film_dim=0, context_dim=6, timesteps=20,
                           latent_t=16, latent_f=8)


@functools.lru_cache(maxsize=2)
def _ldm_pair(kind: str):
    cfg = _cfg(kind == "film")
    jm = j_ldm.LatentDiffusion(cfg, rngs=nnx.Rngs(0))
    tm = port_of(jm, t_ldm.LatentDiffusion(cfg, device="cpu"), 1)
    return jm, tm, cfg


@pytest.fixture(scope="module", params=["film", "context"])
def ldm_pair(request):
    return _ldm_pair(request.param)


@pytest.fixture(scope="module")
def film_pair():
    """ddim_sample conditions on FiLM (it passes no context)."""
    return _ldm_pair("film")


def _cond(cfg, b: int, seed: int):
    rng = np.random.default_rng(seed)
    film = (rng.normal(size=(b, cfg.film_dim)).astype(np.float32)
            if cfg.film_dim else None)
    ctx = (rng.normal(size=(b, 3, cfg.context_dim)).astype(np.float32)
           if cfg.context_dim and not cfg.film_dim else None)
    return film, ctx


def _opt(a, f=T):
    return None if a is None else f(a)


def test_unet_matches_jax(ldm_pair):
    """UNet2D at ldm_tiny_test() (FiLM) and with a cross-attention context
    instead (film_dim 0, context_dim 6)."""
    jm, tm, cfg = ldm_pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, cfg.latent_t, cfg.latent_f,
                         cfg.in_channels)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    film, ctx = _cond(cfg, 2, 3)
    want = nnx.jit(lambda m, x, t, f, c: m(x, t, film=f, context=c))(
        jm.unet, x, t, _opt(film, jnp.asarray), _opt(ctx, jnp.asarray))
    with torch.no_grad():
        got = tm.unet(T(nchw(x)), T(t), film=_opt(film), context=_opt(ctx))
    assert got.shape == (2, cfg.in_channels, cfg.latent_t, cfg.latent_f)
    assert rel_rms(nhwc(N(got)), want) < MODULE_REL_RMS
    if cfg.film_dim:
        with pytest.raises(ValueError, match="film"):
            tm.unet(T(nchw(x)), T(t))


def test_q_sample_and_loss_match_jax(ldm_pair):
    """``q_sample`` and ``loss`` with JAX's t and noise handed in (drawn by
    JAX's own ``loss`` key split)."""
    jm, tm, cfg = ldm_pair
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(3, cfg.latent_t, cfg.latent_f,
                          cfg.in_channels)).astype(np.float32)
    film, ctx = _cond(cfg, 3, 5)
    key = jax.random.key(9)
    rt, rn = jax.random.split(key)
    t = np.asarray(jax.random.randint(rt, (3,), 0, cfg.timesteps))
    noise = np.asarray(jax.random.normal(rn, x0.shape, jnp.float32))
    want_q = np.asarray(jm.q_sample(jnp.asarray(x0), jnp.asarray(t),
                                    jnp.asarray(noise)))
    got_q = N(tm.q_sample(T(nchw(x0)), T(t), T(nchw(noise))))
    assert rel_rms(nhwc(got_q), want_q) < MODULE_REL_RMS
    want = float(jm.loss(jnp.asarray(x0), film=_opt(film, jnp.asarray),
                         context=_opt(ctx, jnp.asarray), rng=key))
    with torch.no_grad():
        got = tm.loss(T(nchw(x0)), film=_opt(film), context=_opt(ctx),
                      t=T(t), noise=T(nchw(noise))).item()
    assert abs(got - want) <= PATH_REL_RMS * abs(want)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("guidance", [2.5, 1.0], ids=["cfg", "no_cfg"])
def test_ddim_sample_matches_jax(film_pair, eta, guidance):
    """DDIM at eta 0 and 0.5, with and without guidance: JAX's per-step
    noise reproduced from its key chain (split a step, normal of the
    sub-key) and handed in as a (steps, ...) tensor."""
    jm, tm, cfg = film_pair
    rng = np.random.default_rng(6)
    b, steps = 2, 7
    x_t = rng.normal(size=(b, cfg.latent_t, cfg.latent_f,
                           cfg.in_channels)).astype(np.float32)
    film, _ = _cond(cfg, b, 7)
    film_u = np.random.default_rng(8).normal(
        size=(1, cfg.film_dim)).astype(np.float32).repeat(b, 0)
    key = jax.random.key(3)
    want = np.asarray(jm.ddim_sample(
        jnp.asarray(x_t), film=jnp.asarray(film),
        film_uncond=jnp.asarray(film_u), steps=steps,
        guidance_scale=guidance, eta=eta, rng=key))
    rows = len(t_ldm.make_ddim_schedule(cfg, steps, eta))
    noise, k = [], key
    for _ in range(rows):
        k, sub = jax.random.split(k)
        noise.append(nchw(jax.random.normal(sub, x_t.shape, jnp.float32)))
    got = N(tm.ddim_sample(T(nchw(x_t)), film=T(film),
                           film_uncond=T(film_u), steps=steps,
                           guidance_scale=guidance, eta=eta,
                           noise=T(np.stack(noise))))
    assert rel_rms(nhwc(got), want) < PATH_REL_RMS


def test_ddim_noise_from_generator(film_pair):
    """Without handed-in noise, eta > 0 draws from the generator: the same
    seed gives the same latents, and equals the same draws handed in."""
    _, tm, cfg = film_pair
    x_t = torch.randn(1, cfg.in_channels, cfg.latent_t, cfg.latent_f,
                      generator=torch.Generator().manual_seed(0))
    film = torch.ones(1, cfg.film_dim)
    rows = len(t_ldm.make_ddim_schedule(cfg, 5, 0.5))
    a = tm.ddim_sample(x_t, film=film, steps=5, eta=0.5,
                       generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    noise = torch.stack([torch.randn(x_t.shape, generator=g)
                         for _ in range(rows)])
    b = tm.ddim_sample(x_t, film=film, steps=5, eta=0.5, noise=noise)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="steps"):
        tm.ddim_sample(x_t, film=film, steps=5, eta=0.5, noise=noise[:2])


# ------------------------------------------------------------ VAE, vocoders

VAE_TINY = dict(mel_bins=8, base_channels=8, channel_mults=(1, 2),
                num_res_blocks=1, latent_channels=2, groups=4)
HIFI_TINY = dict(in_channels=8, upsample_initial_channel=32,
                 upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                 resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))
HIFI_ODD = dict(in_channels=8, upsample_initial_channel=16,
                upsample_rates=(5, 2), upsample_kernel_sizes=(16, 4),
                resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3),
                                                                  (1, 2)))


@pytest.fixture(scope="module")
def vae_pair():
    jm = j_vae.AudioLDMVAE(j_vae.AudioLDMVAEConfig(**VAE_TINY),
                           rngs=nnx.Rngs(0))
    tm = port_of(jm, t_vae.AudioLDMVAE(t_vae.AudioLDMVAEConfig(**VAE_TINY),
                                       device="cpu"), 2, scale=0.2)
    return jm, tm


@pytest.mark.parametrize("sample", [False, True], ids=["mean", "sample"])
def test_vae_encode_decode_match_jax(vae_pair, sample):
    jm, tm = vae_pair
    mel = np.random.default_rng(9).normal(size=(2, 16, 8)).astype(np.float32)
    key = jax.random.key(5) if sample else None
    want = np.asarray(jm.encode(jnp.asarray(mel), key))
    noise = (nchw(jax.random.normal(key, want.shape)) if sample else None)
    with torch.no_grad():
        z = tm.encode(T(mel), noise=_opt(noise))
    assert z.shape == (2, 2, 8, 4)            # one x2 stage at this width
    assert rel_rms(nhwc(N(z)), want) < MODULE_REL_RMS
    want_mel = np.asarray(jm.decode(jnp.asarray(want)))
    with torch.no_grad():
        got_mel = N(tm.decode(T(nchw(want))))
    assert got_mel.shape == want_mel.shape == (2, 16, 8)
    assert rel_rms(got_mel, want_mel) < MODULE_REL_RMS


@pytest.mark.parametrize("kw", [HIFI_TINY, HIFI_ODD], ids=["even", "odd"])
def test_hifigan_matches_jax(kw):
    """The tiny vocoder, and one with an odd k - u (16 -> 5): JAX's output
    length, ``(L - 1) * u + k - 2 * ((k - u) // 2)`` a stage."""
    jm = j_hifi.HiFiGANGenerator(j_hifi.HiFiGANConfig(**kw), rngs=nnx.Rngs(0))
    tm = port_of(jm, t_hifi.HiFiGANGenerator(t_hifi.HiFiGANConfig(**kw),
                                             device="cpu"), 3, scale=0.2)
    mel = np.random.default_rng(10).normal(size=(2, 11, 8)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(mel)))
    with torch.no_grad():
        got = N(tm(T(mel)))
    assert got.shape == want.shape
    assert rel_rms(got, want) < MODULE_REL_RMS


def test_vae_vocoder_matches_jax():
    """Flat (b, l, zc * f) latents -> VAE mel -> HiFi-GAN."""
    rngs = nnx.Rngs(0)
    jm = j_vae.VaeVocoder(
        j_vae.AudioLDMVAE(j_vae.AudioLDMVAEConfig(**VAE_TINY), rngs=rngs),
        j_hifi.HiFiGANGenerator(j_hifi.HiFiGANConfig(**HIFI_TINY),
                                rngs=rngs), rngs=rngs)
    tm = port_of(jm, t_vae.VaeVocoder(
        t_vae.AudioLDMVAE(t_vae.AudioLDMVAEConfig(**VAE_TINY), device="cpu"),
        t_hifi.HiFiGANGenerator(t_hifi.HiFiGANConfig(**HIFI_TINY),
                                device="cpu"), device="cpu"), 4, scale=0.2)
    lat = np.random.default_rng(11).normal(size=(2, 5, 8)).astype(np.float32)
    want = np.asarray(jm.decode(jnp.asarray(lat)))
    with torch.no_grad():
        got = N(tm.decode(T(lat)))
    assert got.shape == want.shape == (2, 5 * 2 * 8)
    assert rel_rms(got, want) < PATH_REL_RMS


# ------------------------------------------------------------- end to end

def _tiny_backends():
    """The tiny configs of the JAX package's own backend test."""
    a_cfg, t_cfg = j_clap.clap_tiny_test()
    ldm_cfg = j_ldm.LDMConfig(
        in_channels=2, out_channels=2, model_channels=16, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8,
        film_dim=a_cfg.projection_dim, timesteps=20, latent_t=8, latent_f=4)
    rngs = nnx.Rngs(0)
    jb = j_ldm.AudioLDMBackend(
        ldm_cfg, clap=j_clap.ClapModel(a_cfg, t_cfg, rngs=rngs),
        vae=j_vae.AudioLDMVAE(j_vae.AudioLDMVAEConfig(**VAE_TINY), rngs=rngs),
        vocoder=j_hifi.HiFiGANGenerator(j_hifi.HiFiGANConfig(**HIFI_TINY),
                                        rngs=rngs), rngs=rngs)
    ta, tt = t_clap.clap_tiny_test()
    tb = t_ldm.AudioLDMBackend(
        ldm_cfg, clap=t_clap.ClapModel(ta, tt, device="cpu"),
        vae=t_vae.AudioLDMVAE(t_vae.AudioLDMVAEConfig(**VAE_TINY),
                              device="cpu"),
        vocoder=t_hifi.HiFiGANGenerator(t_hifi.HiFiGANConfig(**HIFI_TINY),
                                        device="cpu"), device="cpu")
    return jb, port_of(jb, tb, 5, scale=0.1), ldm_cfg


def test_text_to_audio_matches_jax():
    """CLAP -> DDIM (CFG against the "" prompt) -> VAE -> HiFi-GAN, with
    JAX's x_t (the first half of its key split) handed in."""
    jb, tb, cfg = _tiny_backends()
    ids = np.array([[0, 5, 9, 2], [0, 3, 7, 2]], np.int32)
    mask = np.ones_like(ids)
    u_ids = np.array([[0, 2, 1, 1]], np.int32)
    u_mask = np.array([[1, 1, 0, 0]], np.int32)
    key = jax.random.key(0)
    want = np.asarray(jb.text_to_audio(
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(u_ids),
        jnp.asarray(u_mask), steps=4, rng=key))
    rx, _ = jax.random.split(key)
    x_t = jax.random.normal(rx, (2, cfg.latent_t, cfg.latent_f,
                                 cfg.in_channels))
    got = N(tb.text_to_audio(T(ids), T(mask), T(u_ids), T(u_mask), steps=4,
                             x_t=T(nchw(x_t))))
    assert got.shape == want.shape == (2, 16 * 8)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert rel_rms(got, want) < PATH_REL_RMS


# ---------------------------------------------- full width, on the meta device

@pytest.mark.parametrize("name", ["ldm_s_full", "vae", "hifigan"])
def test_full_width_parameters_match_jax(name):
    """Every parameter of the JAX model at its published width (built
    abstractly) has its place and shape in the port's (on the meta device),
    and no port tensor is left over: audioldm-s-full's LatentDiffusion
    (185 M), the default VAE and the default HiFi-GAN."""
    build = {
        "ldm_s_full": (lambda: j_ldm.LatentDiffusion(
            j_ldm.ldm_s_full(), rngs=nnx.Rngs(0)),
            lambda: t_ldm.LatentDiffusion(t_ldm.ldm_s_full(),
                                          device="meta")),
        "vae": (lambda: j_vae.AudioLDMVAE(rngs=nnx.Rngs(0)),
                lambda: t_vae.AudioLDMVAE(device="meta")),
        "hifigan": (lambda: j_hifi.HiFiGANGenerator(rngs=nnx.Rngs(0)),
                    lambda: t_hifi.HiFiGANGenerator(device="meta")),
    }[name]
    abstract = nnx.eval_shape(build[0])
    shapes = {".".join(map(str, path)): tuple(v.shape) for path, v in
              nnx.to_flat_state(nnx.state(abstract, nnx.Param))}
    tm = build[1]()
    tensors = dict(tm.named_parameters())
    placed = set()
    for key, shape in shapes.items():
        target, transform = _target(tm, key)
        want = transform(np.broadcast_to(np.float32(0), shape)).shape
        assert tuple(tensors[target].shape) == want, key
        placed.add(target)
    assert placed == set(tensors)


# ------------------------------------------------------------------ readers

def unet_layout(unet) -> dict:
    """{reference key: shape} of an AudioLDM UNet state dict for the port's
    ``unet``: the names of the reference's ``UNetModel``."""
    p = {k: list(v.shape) for k, v in unet.named_parameters()}
    out = {}

    def leaves(dst, key, names=("weight", "bias")):
        for n in names:
            if f"{dst}.{n}" in p:
                out[f"{key}.{n}"] = p[f"{dst}.{n}"]

    def conv1x1(dst, key):
        out[f"{key}.weight"] = p[f"{dst}.weight"] + [1, 1]
        out[f"{key}.bias"] = p[f"{dst}.bias"]

    def layer(mod, dst, key):
        if isinstance(mod, t_ldm.ResBlock):
            for d, k in (("norm1", "in_layers.0"), ("conv1", "in_layers.2"),
                         ("emb", "emb_layers.1"), ("norm2", "out_layers.0"),
                         ("conv2", "out_layers.3")):
                leaves(f"{dst}.{d}", f"{key}.{k}")
            if mod.skip is not None:
                conv1x1(f"{dst}.skip", f"{key}.skip_connection")
        elif isinstance(mod, t_ldm.SpatialTransformer):
            leaves(f"{dst}.norm", f"{key}.norm")
            conv1x1(f"{dst}.proj_in", f"{key}.proj_in")
            conv1x1(f"{dst}.proj_out", f"{key}.proj_out")
            for t in range(len(mod.blocks)):
                d, k = f"{dst}.blocks.{t}", f"{key}.transformer_blocks.{t}"
                for nm in ("norm1", "norm2", "norm3"):
                    leaves(f"{d}.{nm}", f"{k}.{nm}")
                for at in ("attn1", "attn2"):
                    for proj in ("to_q", "to_k", "to_v"):
                        leaves(f"{d}.{at}.{proj}", f"{k}.{at}.{proj}")
                    leaves(f"{d}.{at}.to_out", f"{k}.{at}.to_out.0")
                leaves(f"{d}.ff.proj", f"{k}.ff.net.0.proj")
                leaves(f"{d}.ff.out", f"{k}.ff.net.2")
        else:
            leaves(f"{dst}.conv", f"{key}." + (
                "op" if isinstance(mod, t_ldm.Downsample) else "conv"))

    leaves("time_dense1", "time_embed.0")
    leaves("time_dense2", "time_embed.2")
    leaves("film_emb", "film_emb")
    leaves("conv_in", "input_blocks.0.0")
    groups = ([(b, f"input_blocks.{i}", f"input_blocks.{i + 1}")
               for i, b in enumerate(unet.input_blocks)]
              + [(unet.middle_block, "middle_block", "middle_block")]
              + [(b, f"output_blocks.{i}", f"output_blocks.{i}")
                 for i, b in enumerate(unet.output_blocks)])
    for blk, dst, key in groups:
        for j, mod in enumerate(blk.layers):
            layer(mod, f"{dst}.layers.{j}", f"{key}.{j}")
    leaves("norm_out", "out.0")
    leaves("conv_out", "out.2")
    return out


def seeded_state(layout: dict, seed: int, prefix: str = "") -> dict:
    g = torch.Generator().manual_seed(seed)
    return {prefix + k: torch.randn(s, generator=g) * 0.05
            for k, s in layout.items()}


class _Slot:
    """Stands for a parameter of an abstract JAX model: records what a
    reader assigns to it (``var[...] = value``)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.value = None

    def __setitem__(self, index, value):
        assert index is Ellipsis
        self.value = value


def _jax_reads(reader, build, layout: dict, **kw) -> None:
    """Run a JAX reader into the abstract model ``build`` makes, on
    ``layout`` with each key's tensor a constant (its index + 1, int16; the
    broadcast takes no memory): every JAX parameter must receive exactly one
    key's constant in its own shape, and every key must be read."""
    model = nnx.eval_shape(build)
    slots = {}
    for path, var in nnx.iter_graph(model):
        if isinstance(var, nnx.Param):
            slots[path] = _Slot(var.get_raw_value().shape)
            var.set_raw_value(slots[path])
    keys = sorted(layout)
    sd = {kw.get("prefix", "") + k: np.broadcast_to(np.int16(i + 1),
                                                     layout[k])
          for i, k in enumerate(keys)}
    reader(sd, model, **kw)
    used = set()
    for path, slot in slots.items():
        assert slot.value is not None, (path, "not filled")
        assert tuple(slot.value.shape) == slot.shape, path
        i = int(np.asarray(slot.value).ravel()[0]) - 1
        assert 0 <= i < len(keys) and i not in used, path
        used.add(i)
    assert used == set(range(len(keys)))


def _full_unet_layout() -> dict:
    full = t_ldm.LatentDiffusion(t_ldm.ldm_s_full(), device="meta").unet
    return unet_layout(full)


def test_full_width_unet_keys_are_what_jax_reads():
    """audioldm-s-full's UNet key list (``tests/golden/
    sd_keys_audioldm_unet.json``, the ``model.diffusion_model.`` subtree
    without its prefix) is exactly what JAX's reader reads into every
    parameter of its full-width UNet, and the port's reader consumes it
    all on the meta device."""
    layout = _full_unet_layout()
    with open(os.path.join(GOLDEN, "sd_keys_audioldm_unet.json")) as f:
        assert json.load(f) == layout
    _jax_reads(j_tc.load_ldm_unet_from_state_dict,
               lambda: j_ldm.UNet2D(j_ldm.ldm_s_full(), rngs=nnx.Rngs(0)),
               layout, prefix=PREFIX)
    meta = torch.device("meta")
    sd = {PREFIX + k: torch.empty(s, device=meta) for k, s in layout.items()}
    unet = t_ldm.LatentDiffusion(t_ldm.ldm_s_full(), device="meta").unet
    assert t_tc.load_ldm_unet_from_state_dict(sd, unet, prefix=PREFIX) == []


@pytest.mark.parametrize("cfg_name", ["film", "context"])
def test_unet_reader_matches_jax(cfg_name):
    """The same seeded state dict (with keys outside the prefix, and a q
    bias JAX ignores) through both readers: the port's UNet equals JAX's
    carried across; the leftovers are named; a missing key and a misfit
    shape raise."""
    cfg = _cfg(cfg_name == "film")
    tm = t_ldm.UNet2D(cfg, device="cpu")
    layout = unet_layout(tm)
    sd = seeded_state(layout, 12, PREFIX)
    q_bias = PREFIX + "input_blocks.1.1.transformer_blocks.0.attn1.to_q.bias"
    sd[q_bias] = torch.ones(16)
    sd["first_stage_model.decoder.conv_in.weight"] = torch.ones(3)
    jm = j_ldm.UNet2D(cfg, rngs=nnx.Rngs(1))
    j_tc.load_ldm_unet_from_state_dict(sd, jm, prefix=PREFIX)
    left = t_tc.load_ldm_unet_from_state_dict(sd, tm, prefix=PREFIX)
    assert left == [q_bias]
    want = t_ldm.UNet2D(cfg, device="cpu")
    load_jax_params(want, flatten_jax(jm))
    for (name, a), (_, b) in zip(tm.state_dict().items(),
                                 want.state_dict().items()):
        assert torch.equal(a, b), name
    missing = dict(sd)
    del missing[PREFIX + "out.2.bias"]
    with pytest.raises(KeyError, match="out.2.bias"):
        t_tc.load_ldm_unet_from_state_dict(missing, tm, prefix=PREFIX)
    bad = dict(sd)
    bad[PREFIX + "time_embed.0.weight"] = torch.ones(3, 3)
    with pytest.raises(ValueError, match="does not fit"):
        t_tc.load_ldm_unet_from_state_dict(bad, tm, prefix=PREFIX)


def test_convert_cli_audioldm_matches_jax_script(tmp_path):
    """``python -m v2ap_torch.convert --audioldm X --tiny --out D`` writes
    ``D/audioldm_unet``; loaded back it equals the UNet that the JAX
    package's ``scripts/convert_checkpoints.py`` path fills from the same
    file (``ckpt.get("state_dict", ckpt)``, prefix
    ``model.diffusion_model.``)."""
    from v2ap_torch.utils.checkpoint import load_model

    cfg = t_ldm.ldm_tiny_test()
    layout = unet_layout(t_ldm.UNet2D(cfg, device="meta"))
    sd = seeded_state(layout, 13, PREFIX)
    sd["cond_stage_model.model.logit_scale_a"] = torch.ones(())
    ckpt = tmp_path / "audioldm.ckpt"
    torch.save({"state_dict": sd, "global_step": 7}, ckpt)
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "v2ap_torch.convert", "--audioldm", str(ckpt),
         "--tiny", "--out", str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "converted audioldm ldm unet" in res.stdout
    assert "0 keys not used" in res.stdout
    got = t_ldm.LatentDiffusion(cfg, device="cpu")
    load_model(str(out / "audioldm_unet"), got)
    jm = j_ldm.LatentDiffusion(j_ldm.ldm_tiny_test(), rngs=nnx.Rngs(0))
    loaded = torch.load(ckpt, map_location="cpu", weights_only=True)
    j_tc.load_ldm_unet_from_state_dict(loaded.get("state_dict", loaded),
                                       jm.unet, prefix=PREFIX)
    want = t_ldm.LatentDiffusion(cfg, device="cpu")
    load_jax_params(want, flatten_jax(jm))
    for (name, a), (_, b) in zip(got.state_dict().items(),
                                 want.state_dict().items()):
        assert torch.equal(a, b), name
