"""AudioLDM's first-stage VAE (mel <-> latent) and the VAE vocoder.

Counterpart of ``v2ap_tpu/models/audioldm_vae.py``: a convolutional
autoencoder over mel spectrograms taken as one-channel images, ResNet
blocks with GroupNorm and swish, one spatial self-attention at the
bottleneck, x2 down / up stages, float32. Images are NCHW here (the JAX
package is NHWC): ``encode`` takes a mel (b, T, mel_bins) and returns
latents (b, latent_channels, T / 4, mel_bins / 4), scaled by
``scale_factor``; ``decode`` inverts that. The posterior sample's noise is
handed in or drawn from a ``torch.Generator``; without either ``encode``
returns the mean. ``VaeVocoder.decode`` takes the flat (b, l, 128) latents
of the token path's ``vae`` option and returns HiFi-GAN's waveform.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Conv2d, GroupNorm
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AudioLDMVAEConfig:
    mel_bins: int = 64
    base_channels: int = 128
    channel_mults: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    latent_channels: int = 8
    scale_factor: float = 0.9227914
    groups: int = 32


def _gn(ch: int, groups: int, device) -> GroupNorm:
    return GroupNorm(ch, min(groups, ch), device=device)


def _conv3(cin: int, cout: int, device, stride: int = 1,
           padding: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=padding,
                  device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, *, device=None):
        super().__init__()
        self.norm1 = _gn(cin, groups, device)
        self.conv1 = _conv3(cin, cout, device)
        self.norm2 = _gn(cout, groups, device)
        self.conv2 = _conv3(cout, cout, device)
        self.shortcut = (Conv2d(cin, cout, 1, device=device)
                         if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.shortcut(x) if self.shortcut is not None else x)


class AttnBlock(nn.Module):
    """Single-head self-attention over the h*w positions, plain products
    in float32 (as in JAX, outside any kernel)."""

    def __init__(self, ch: int, groups: int, *, device=None):
        super().__init__()
        self.norm = _gn(ch, groups, device)
        self.q = Conv2d(ch, ch, 1, device=device)
        self.k = Conv2d(ch, ch, 1, device=device)
        self.v = Conv2d(ch, ch, 1, device=device)
        self.proj = Conv2d(ch, ch, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)

        def tokens(conv):
            return conv(hn).flatten(2).transpose(1, 2)       # (b, hw, c)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        att = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1)
        out = (att @ v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj(out)


class Downsample(nn.Module):
    """Stride-2 3x3 convolution after one zero row and column at the far
    ends (JAX's padding ((0, 1), (0, 1)))."""

    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv = _conv3(ch, ch, device, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv = _conv3(ch, ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class AudioLDMVAE(nn.Module):
    def __init__(self, cfg: AudioLDMVAEConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or AudioLDMVAEConfig()
        g = cfg.groups
        chs = [cfg.base_channels * m for m in cfg.channel_mults]
        zc = cfg.latent_channels

        # encoder
        self.conv_in = _conv3(1, chs[0], device)
        self.down_blocks = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        cin = chs[0]
        for i, ch in enumerate(chs):
            blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(cin, ch, g, device=device))
                cin = ch
            self.down_blocks.append(blocks)
            self.downsamples.append(Downsample(ch, device=device)
                                    if i < len(chs) - 1 else None)
        self.mid1 = ResnetBlock(cin, cin, g, device=device)
        self.mid_attn = AttnBlock(cin, g, device=device)
        self.mid2 = ResnetBlock(cin, cin, g, device=device)
        self.enc_norm = _gn(cin, g, device)
        self.enc_out = _conv3(cin, 2 * zc, device)
        self.quant = Conv2d(2 * zc, 2 * zc, 1, device=device)

        # decoder
        self.post_quant = Conv2d(zc, zc, 1, device=device)
        self.dec_in = _conv3(zc, chs[-1], device)
        self.dmid1 = ResnetBlock(chs[-1], chs[-1], g, device=device)
        self.dmid_attn = AttnBlock(chs[-1], g, device=device)
        self.dmid2 = ResnetBlock(chs[-1], chs[-1], g, device=device)
        self.up_blocks = nn.ModuleList()
        self.upsamples = nn.ModuleList()
        cin = chs[-1]
        for i, ch in enumerate(reversed(chs)):
            blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, ch, g, device=device))
                cin = ch
            self.up_blocks.append(blocks)
            self.upsamples.append(Upsample(ch, device=device)
                                  if i < len(chs) - 1 else None)
        self.dec_norm = _gn(cin, g, device)
        self.dec_out = _conv3(cin, 1, device)

    def encode(self, mel: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel (b, T, mel_bins) -> scaled latents (b, zc, T/4, mel_bins/4):
        the posterior mean, or a sample when ``noise`` (the latents' shape)
        is handed in or ``generator`` given."""
        h = self.conv_in(mel.float()[:, None])
        for blocks, down in zip(self.down_blocks, self.downsamples):
            for blk in blocks:
                h = blk(h)
            if down is not None:
                h = down(h)
        h = self.mid2(self.mid_attn(self.mid1(h)))
        moments = self.quant(self.enc_out(F.silu(self.enc_norm(h))))
        mean, logvar = moments.chunk(2, dim=1)
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device).to(mean.device)
        if noise is not None:
            logvar = logvar.clamp(-30.0, 20.0)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.cfg.scale_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (b, zc, T/4, mel_bins/4) -> mel (b, T, mel_bins)."""
        h = self.dec_in(self.post_quant(z.float() / self.cfg.scale_factor))
        h = self.dmid2(self.dmid_attn(self.dmid1(h)))
        for blocks, up in zip(self.up_blocks, self.upsamples):
            for blk in blocks:
                h = blk(h)
            if up is not None:
                h = up(h)
        return self.dec_out(F.silu(self.dec_norm(h)))[:, 0]


class VaeVocoder(nn.Module):
    """Flat latents -> mel (the VAE) -> waveform (HiFi-GAN)."""

    def __init__(self, vae: AudioLDMVAE | None = None, vocoder=None, *,
                 device=None):
        super().__init__()
        from v2ap_torch.models.hifigan import HiFiGANGenerator

        device = resolve_device(device)
        self.vae = vae or AudioLDMVAE(device=device)
        self.vocoder = vocoder or HiFiGANGenerator(device=device)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, l, d) flat latents, d = latent_channels x frequency bins ->
        waveform (b, samples): each frame's d values are zc rows of d / zc
        bins."""
        b, l, d = latents.shape
        zc = self.vae.cfg.latent_channels
        z = latents.reshape(b, l, zc, d // zc).permute(0, 2, 1, 3)
        return self.vocoder(self.vae.decode(z))
