"""Roll2Midi GAN: cleans estimated piano-roll probability windows into crisp
MIDI activations (Audeo stage 2; reference: src/audeo/Roll2MidiNet.py and
Roll2MidiNet_enhance.py).

Counterpart of ``v2ap_tpu/audeo/roll2midi.py``. The "U-Net" is stride-1
throughout: a deep conv stack whose decoder concatenates encoder features
channel-wise. Down blocks: 3x3 conv (no bias) + BatchNorm (eps 0.8, the
reference's positional eps) + LeakyReLU 0.2 + dropout. Up blocks: 3x3 conv
(a stride-1 "transposed" conv) + BatchNorm + ReLU + dropout, then the skip
concat. Head: 1x1 conv + sigmoid. The discriminator is an LSGAN PatchGAN (3
stride-2 blocks + 1 stride-1, InstanceNorm without affine: the biased
variance, eps 1e-5). The enhance variant gates the decoder's skips with
additive attention.

Roll windows are (b, keys, frames, 1) at the modules' boundary, as in JAX,
so arrays and npz files are the same in both packages; inside, the
convolutions run NCHW. Dropout (0.5 on down3-6 and up1-2) draws from the
generator's own seeded ``torch.Generator``; ``train=True`` normalises with
the batch statistics and updates the running ones as flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import BatchNorm2d, Conv2d, Dropout
from v2ap_torch.utils.device import resolve_device

BN_EPS = 0.8


class DownBlock(nn.Module):
    def __init__(self, cin, cout, normalize=True, dropout=0.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, bias=False, dtype=dtype,
                           device=device)
        self.bn = (BatchNorm2d(cout, eps=BN_EPS, device=device)
                   if normalize else None)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, train=False, deterministic=True):
        h = self.conv(x)
        if self.bn is not None:
            h = self.bn(h, train)
        h = F.leaky_relu(h, 0.2)
        if self.dropout is not None:
            h = self.dropout(h, deterministic=deterministic)
        return h


class UpBlock(nn.Module):
    def __init__(self, cin, cout, dropout=0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, bias=False, dtype=dtype,
                           device=device)
        self.bn = BatchNorm2d(cout, eps=BN_EPS, device=device)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, skip, train=False, deterministic=True):
        h = F.relu(self.bn(self.conv(x), train))
        if self.dropout is not None:
            h = self.dropout(h, deterministic=deterministic)
        return torch.cat([h, skip.to(h.dtype)], dim=1)


class AttentionGate(nn.Module):
    """Additive attention gate (enhance variant,
    Roll2MidiNet_enhance.py:41-55): x * sigmoid(psi(theta(x) + phi(g)))."""

    def __init__(self, cin, cg, cout, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.theta_x = Conv2d(cin, cout, 1, **kw)
        self.phi_g = Conv2d(cg, cout, 1, **kw)
        self.psi = Conv2d(cout, 1, 1, **kw)

    def forward(self, x, g):
        return x * torch.sigmoid(self.psi(self.theta_x(x) + self.phi_g(g)))


class Roll2MidiGenerator(nn.Module):
    """(b, keys, frames, 1) roll probabilities -> the same shape, float32
    sigmoid activations."""

    def __init__(self, channels: int = 1, enhance: bool = False, *,
                 dtype=torch.float32, device=None, dropout_seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.enhance = enhance
        kw = dict(dtype=dtype, device=device)
        self.down1 = DownBlock(channels, 64, normalize=False, **kw)
        self.down2 = DownBlock(64, 128, **kw)
        self.down3 = DownBlock(128, 256, dropout=0.5, **kw)
        self.down4 = DownBlock(256, 512, dropout=0.5, **kw)
        self.down5 = DownBlock(512, 1024, dropout=0.5, **kw)
        self.down6 = DownBlock(1024, 1024, dropout=0.5, **kw)
        if not enhance:
            self.up1 = UpBlock(1024, 512, dropout=0.5, **kw)
            self.up2 = UpBlock(1024 + 512, 256, dropout=0.5, **kw)
            self.up3 = UpBlock(512 + 256, 128, **kw)
            self.up4 = UpBlock(256 + 128, 64, **kw)
            self.up5 = UpBlock(128 + 64, 16, **kw)
            head_in = 80
        else:
            self.att1 = AttentionGate(2048, 1024, 512, **kw)
            self.att2 = AttentionGate(1024, 512, 256, **kw)
            self.att3 = AttentionGate(512, 256, 128, **kw)
            self.att4 = AttentionGate(256, 128, 64, **kw)
            self.up1 = UpBlock(1024, 1024, dropout=0.5, **kw)
            self.up2 = UpBlock(2048, 512, dropout=0.5, **kw)
            self.up3 = UpBlock(1024, 256, **kw)
            self.up4 = UpBlock(512, 128, **kw)
            self.up5 = UpBlock(256, 64, **kw)
            head_in = 128
        self.head = Conv2d(head_in, 1, 1, **kw)
        self.dropout_generator = torch.Generator(device=device)
        self.dropout_generator.manual_seed(dropout_seed)
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator

    def forward(self, x, train=False, deterministic=True):
        kw = dict(train=train, deterministic=deterministic)
        d1 = self.down1(x.permute(0, 3, 1, 2), **kw)
        d2 = self.down2(d1, **kw)
        d3 = self.down3(d2, **kw)
        d4 = self.down4(d3, **kw)
        d5 = self.down5(d4, **kw)
        d6 = self.down6(d5, **kw)
        if not self.enhance:
            u = self.up1(d6, d5, **kw)
            u = self.up2(u, d4, **kw)
            u = self.up3(u, d3, **kw)
            u = self.up4(u, d2, **kw)
            u = self.up5(u, d1, **kw)
        else:
            u = self.att1(self.up1(d6, d5, **kw), d5)
            u = self.att2(self.up2(u, d4, **kw), d4)
            u = self.att3(self.up3(u, d3, **kw), d3)
            u = self.att4(self.up4(u, d2, **kw), d2)
            u = self.up5(u, d1, **kw)
        return torch.sigmoid(self.head(u).float()).permute(0, 2, 3, 1)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per sample and channel over H, W; no affine; biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).pow(2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class Roll2MidiDiscriminator(nn.Module):
    """LSGAN PatchGAN over (b, keys, frames, 1) roll windows (reference
    Roll2MidiNet.py:90-120) -> (b, *output_shape) float32 patch scores."""

    def __init__(self, channels: int = 1, height: int = 51, width: int = 100,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.output_shape = (height // 8 + 1, width // 8 + 1, 1)
        specs = [(64, 2, False), (128, 2, True), (256, 2, True), (512, 1, True)]
        self.convs = nn.ModuleList()
        self.normalize = []
        cin = channels
        for cout, stride, normalize in specs:
            self.convs.append(Conv2d(cin, cout, 3, stride=stride, padding=1,
                                     dtype=dtype, device=device))
            self.normalize.append(normalize)
            cin = cout
        self.head = Conv2d(cin, 1, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv, normalize in zip(self.convs, self.normalize):
            x = conv(x)
            if normalize:
                x = _instance_norm(x)
            x = F.leaky_relu(x, 0.2)
        return self.head(x).float().permute(0, 2, 3, 1)
