"""AudioLDM latent diffusion: the UNet, the DDPM schedule, DDIM sampling
and the text-to-audio backend.

Counterpart of ``v2ap_tpu/models/latent_diffusion.py``, NCHW (the JAX
package is NHWC): latents are (b, C, T, F). Float32 throughout.

  * ``UNet2D``: the AudioLDM UNet. ResBlocks (GroupNorm, SiLU, 3x3
    convolutions, the embedding added per channel, a zero-initialised
    second convolution), SpatialTransformers (1x1 in, pre-LN self- and
    cross-attention with bias-free q / k / v, a GEGLU feed-forward, a
    zero-initialised 1x1 out) at the ``attention_resolutions``, stride-2
    down and nearest x2 up. The time embedding ([cos | sin] order) is
    concatenated with the FiLM embedding of the CLAP vector. The 1x1
    convolutions are ``Conv1x1``, a ``Linear`` over the channels, as JAX's
    ``nnx.Linear``. The attention is plain products and softmax, as JAX's
    ``_attend``: no flash kernel runs here.
  * ``make_betas`` / ``make_ddim_schedule``: float64 host tables, the DDIM
    subset by the uniform stride ``timesteps // steps`` (so the step count
    is ``ceil(timesteps / stride)``, ``steps`` only where it divides), + 1;
    a stride that divides ``timesteps - 1`` raises, as in JAX.
  * ``LatentDiffusion``: ``q_sample``, the eps-MSE ``loss`` (t and noise
    handed in or drawn from a generator) and ``ddim_sample``: an eager loop
    of one UNet call a step, classifier-free guidance folded into one
    batch-doubled call, ``eta > 0`` noise handed in as a (steps, ...)
    tensor or drawn from a generator.
  * ``AudioLDMBackend.text_to_audio``: CLAP text features of the prompts
    and of the unconditional prompt, DDIM, the VAE's mel decode, HiFi-GAN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Conv2d, GroupNorm, LayerNorm, Linear
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LDMConfig:
    in_channels: int = 8
    out_channels: int = 8
    model_channels: int = 128
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 5)
    num_head_channels: int = 32
    transformer_depth: int = 1
    film_dim: int = 512                  # CLAP embedding; 0 disables FiLM
    context_dim: int = 0                 # cross-attention context; 0 = none
    timesteps: int = 1000
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    latent_t: int = 256                  # 10 s of 16 kHz mel at hop 160, /4
    latent_f: int = 16
    scale_factor: float = 1.0


def ldm_s_full() -> LDMConfig:
    """audioldm-s-full."""
    return LDMConfig()


def ldm_tiny_test() -> LDMConfig:
    return LDMConfig(in_channels=4, out_channels=4, model_channels=16,
                     num_res_blocks=1, attention_resolutions=(2,),
                     channel_mult=(1, 2), num_head_channels=8, film_dim=12,
                     timesteps=20, latent_t=16, latent_f=8)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding (b, dim), [cos | sin] order, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Conv1x1(Linear):
    """A 1x1 convolution over NCHW inputs, held as a ``Linear`` (weight
    (out, in))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.float(), self.weight[:, :, None, None], self.bias)


def _conv3(cin: int, cout: int, device, *, stride: int = 1,
           zero: bool = False) -> Conv2d:
    conv = Conv2d(cin, cout, 3, stride=stride, padding=1, device=device)
    if zero:
        nn.init.zeros_(conv.weight)
    return conv


def _gn(ch: int, device) -> GroupNorm:
    return GroupNorm(ch, 32 if ch % 32 == 0 else min(ch, 8), eps=1e-5,
                     device=device)


class ResBlock(nn.Module):
    def __init__(self, cin: int, emb_dim: int, cout: int, *, device=None):
        super().__init__()
        self.norm1 = _gn(cin, device)
        self.conv1 = _conv3(cin, cout, device)
        self.emb = Linear(emb_dim, cout, device=device)
        self.norm2 = _gn(cout, device)
        self.conv2 = _conv3(cout, cout, device, zero=True)
        self.skip = Conv1x1(cin, cout, device=device) if cin != cout else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.emb(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.skip(x) if self.skip is not None else x) + h


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int) -> torch.Tensor:
    """(b, n, h*d) x (b, m, h*d) -> (b, n, h*d), plain products."""
    b, n, hd = q.shape
    d = hd // heads

    def split(t):
        return t.reshape(b, -1, heads, d).transpose(1, 2)

    s = split(q) @ split(k).transpose(-1, -2) / math.sqrt(d)
    out = torch.softmax(s, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(b, n, hd)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, *, device=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False, device=device)
        self.to_k = Linear(ctx_dim, dim, bias=False, device=device)
        self.to_v = Linear(ctx_dim, dim, bias=False, device=device)
        self.to_out = Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = x if context is None else context
        return self.to_out(_attend(self.to_q(x), self.to_k(c), self.to_v(c),
                                   self.heads))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.proj = Linear(dim, dim * 8, device=device)
        self.out = Linear(dim * 4, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.gelu(gate))              # exact (erf) GELU


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, *, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, device=device)
        self.attn1 = CrossAttention(dim, dim, heads, device=device)
        self.norm2 = LayerNorm(dim, 1e-6, device=device)
        self.attn2 = CrossAttention(dim, ctx_dim or dim, heads, device=device)
        self.norm3 = LayerNorm(dim, 1e-6, device=device)
        self.ff = GEGLUFeedForward(dim, device=device)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 in, transformer blocks over the h*w positions (row
    major), zero-initialised 1x1 out, residual."""

    def __init__(self, ch: int, heads: int, depth: int, ctx_dim: int, *,
                 device=None):
        super().__init__()
        self.norm = _gn(ch, device)
        self.proj_in = Linear(ch, ch, device=device)
        self.blocks = nn.ModuleList([
            TransformerBlock(ch, ctx_dim, heads, device=device)
            for _ in range(depth)])
        self.proj_out = Linear(ch, ch, zero_init=True, device=device)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.blocks:
            t = blk(t, context)
        return x + self.proj_out(t).transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv = _conv3(ch, ch, device, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv = _conv3(ch, ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Block(nn.Module):
    """One of the reference's TimestepEmbedSequential groups."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, emb, context=None):
        for layer in self.layers:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNet2D(nn.Module):
    def __init__(self, cfg: LDMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_dense1 = Linear(mc, ted, device=device)
        self.time_dense2 = Linear(ted, ted, device=device)
        if cfg.film_dim:
            self.film_emb = Linear(cfg.film_dim, ted, device=device)
        emb_dim = ted * 2 if cfg.film_dim else ted
        ctx = cfg.context_dim if (cfg.context_dim and not cfg.film_dim) else 0

        def attn(ch):
            return SpatialTransformer(ch, ch // cfg.num_head_channels,
                                      cfg.transformer_depth, ctx,
                                      device=device)

        self.conv_in = _conv3(cfg.in_channels, mc, device)
        self.input_blocks = nn.ModuleList()
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, emb_dim, mult * mc, device=device)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(_Block(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(_Block([Downsample(ch,
                                                            device=device)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = _Block([ResBlock(ch, emb_dim, ch, device=device),
                                    attn(ch),
                                    ResBlock(ch, emb_dim, ch, device=device)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                ich = chans.pop()
                layers = [ResBlock(ch + ich, emb_dim, mult * mc,
                                   device=device)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, device=device))
                    ds //= 2
                self.output_blocks.append(_Block(layers))
        self.norm_out = _gn(ch, device)
        self.conv_out = _conv3(ch, cfg.out_channels, device, zero=True)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                film: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (b, C, T, F), t (b,) integer timesteps, film (b, film_dim),
        context (b, m, context_dim) -> eps (b, C, T, F)."""
        emb = self.time_dense2(F.silu(self.time_dense1(
            timestep_embedding(t, self.cfg.model_channels))))
        if self.cfg.film_dim:
            if film is None:
                raise ValueError("film conditioning required")
            emb = torch.cat([emb, self.film_emb(film)], dim=-1)
        h = self.conv_in(x.float())
        hs = [h]
        for blk in self.input_blocks:
            h = blk(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for blk in self.output_blocks:
            h = blk(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.conv_out(F.silu(self.norm_out(h)))


# ------------------------------------------------------------------ schedules

def make_betas(cfg: LDMConfig) -> np.ndarray:
    """The linear schedule in sqrt space, float64."""
    return np.linspace(cfg.linear_start ** 0.5, cfg.linear_end ** 0.5,
                       cfg.timesteps, dtype=np.float64) ** 2


def make_ddim_schedule(cfg: LDMConfig, steps: int,
                       eta: float = 0.0) -> np.ndarray:
    """(steps', 5) float64 rows (t, a_t, a_prev, sigma, sqrt(1 - a_t)) in
    sampling order over the timesteps ``arange(0, T, T // steps) + 1``.
    A stride that divides T - 1 (steps >= T; 333 of 1000) reaches timestep
    T, past the table, and raises IndexError, as in the JAX package and the
    reference."""
    alphas_cum = np.cumprod(1.0 - make_betas(cfg))
    c = max(1, cfg.timesteps // steps)
    ts = np.arange(0, cfg.timesteps, c) + 1
    a = alphas_cum[ts]
    a_prev = np.concatenate([[alphas_cum[0]], alphas_cum[ts[:-1]]])
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    table = np.stack([ts.astype(np.float64), a, a_prev, sigma,
                      np.sqrt(1.0 - a)], axis=1)[::-1]
    return table.copy()


def _draw(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    gen_dev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_dev).to(device)


class LatentDiffusion(nn.Module):
    def __init__(self, cfg: LDMConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg or LDMConfig()
        self.unet = UNet2D(self.cfg, device=device)
        ac = np.cumprod(1.0 - make_betas(self.cfg))
        self.register_buffer("sqrt_ac", torch.from_numpy(
            np.sqrt(ac).astype(np.float32)).to(device), persistent=False)
        self.register_buffer("sqrt_1mac", torch.from_numpy(
            np.sqrt(1.0 - ac).astype(np.float32)).to(device),
            persistent=False)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return (self.sqrt_ac[t].reshape(shape) * x0
                + self.sqrt_1mac[t].reshape(shape) * noise)

    def loss(self, x0: torch.Tensor, *, film=None, context=None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The eps-prediction MSE; ``t`` (b,) uniform in [0, timesteps) and
        ``noise`` like ``x0`` handed in or drawn from ``generator``."""
        dev = x0.device
        if t is None:
            gen_dev = generator.device if generator is not None else dev
            t = torch.randint(0, self.cfg.timesteps, (x0.shape[0],),
                              generator=generator, device=gen_dev).to(dev)
        if noise is None:
            noise = _draw(x0.shape, generator, dev)
        eps = self.unet(self.q_sample(x0, t, noise), t, film=film,
                        context=context)
        return ((eps - noise) ** 2).mean()

    @torch.no_grad()
    def ddim_sample(self, x_t: torch.Tensor, *, film: torch.Tensor,
                    film_uncond: Optional[torch.Tensor] = None,
                    steps: int = 25, guidance_scale: float = 2.5,
                    eta: float = 0.0, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """DDIM from ``x_t`` (b, C, T, F) with classifier-free guidance
        (``film_uncond`` the unconditional CLAP vector, zeros if None).
        With ``eta > 0`` each step adds ``sigma * noise[i]``: ``noise``
        (steps', b, C, T, F) handed in, else drawn from ``generator`` a step
        at a time."""
        b = x_t.shape[0]
        dev = x_t.device
        rows = make_ddim_schedule(self.cfg, steps, eta)
        table = torch.as_tensor(rows, dtype=torch.float32, device=dev)
        cfg_on = guidance_scale != 1.0 and film is not None
        if cfg_on:
            film_in = torch.cat([film_uncond if film_uncond is not None
                                 else torch.zeros_like(film), film])
        else:
            film_in = film
        stochastic = bool((rows[:, 3] > 0).any())
        if noise is not None and noise.shape[0] != len(rows):
            raise ValueError(f"noise has {noise.shape[0]} steps, the "
                             f"schedule {len(rows)}")
        x = x_t.float()
        for i in range(len(rows)):
            t_f, a, a_prev, sigma, sq1ma = table[i]
            t = t_f.to(torch.int32).expand(b)
            if cfg_on:
                eps2 = self.unet(torch.cat([x, x]), torch.cat([t, t]),
                                 film=film_in)
                eps_u, eps_c = eps2[:b], eps2[b:]
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            else:
                eps = self.unet(x, t, film=film_in)
            pred_x0 = (x - sq1ma * eps) / torch.sqrt(a)
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2,
                                            min=0.0)) * eps
            x = torch.sqrt(a_prev) * pred_x0 + dir_xt
            if stochastic:
                n = noise[i] if noise is not None else _draw(x.shape,
                                                             generator, dev)
                x = x + sigma * n.to(dev)
        return x


class AudioLDMBackend(nn.Module):
    """CLAP text features -> FiLM-conditioned DDIM -> VAE mel decode ->
    HiFi-GAN: text-to-audio at 16 kHz."""

    def __init__(self, cfg: LDMConfig | None = None, *, clap=None, vae=None,
                 vocoder=None, device=None):
        super().__init__()
        from v2ap_torch.models.audioldm_vae import AudioLDMVAE
        from v2ap_torch.models.clap import ClapModel
        from v2ap_torch.models.hifigan import HiFiGANGenerator

        device = resolve_device(device)
        self.ldm = LatentDiffusion(cfg, device=device)
        self.clap = clap or ClapModel(device=device)
        self.vae = vae or AudioLDMVAE(device=device)
        self.vocoder = vocoder or HiFiGANGenerator(device=device)

    def latent_shape(self, b: int) -> tuple:
        cfg = self.ldm.cfg
        return (b, cfg.in_channels, cfg.latent_t, cfg.latent_f)

    @torch.no_grad()
    def text_to_audio(self, ids: torch.Tensor, mask: torch.Tensor,
                      uncond_ids: torch.Tensor, uncond_mask: torch.Tensor, *,
                      steps: int = 25, guidance_scale: float = 2.5,
                      x_t: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Tokenized prompts (b, m) and the unconditional prompt (1, m) ->
        waveform (b, samples) at 16 kHz. ``x_t`` (b, C, T, F) is handed in
        or drawn from ``generator``; DDIM runs at eta 0."""
        film = self.clap.get_text_features(ids, mask)
        film_u = self.clap.get_text_features(uncond_ids, uncond_mask)
        film_u = film_u.expand_as(film)
        if x_t is None:
            x_t = _draw(self.latent_shape(film.shape[0]), generator,
                        film.device)
        z = self.ldm.ddim_sample(x_t, film=film, film_uncond=film_u,
                                 steps=steps, guidance_scale=guidance_scale)
        mel = self.vae.decode(z / self.ldm.cfg.scale_factor)
        return self.vocoder(mel)
