"""HiFi-GAN generator: mel spectrogram -> waveform.

Counterpart of ``v2ap_tpu/models/hifigan.py`` (the AudioLDM vocoder, 16 kHz,
hop 160): conv_pre -> per upsampling stage a leaky-ReLU (0.1), a transposed
convolution and the mean of the multi-receptive-field residual blocks ->
leaky-ReLU, conv_post, tanh. NCW inside, float32, weight norm folded into
the weights. The transposed convolution trims ``(k - u) // 2`` samples at
each end as the JAX package does, so a stage maps L frames to
``(L - 1) * u + k - 2 * ((k - u) // 2)`` samples: the default config gives
``160 * frames + 32`` samples (16 -> 5 and 16 -> 4 have odd ``k - u``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops import layers
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    in_channels: int = 64                 # mel bins
    upsample_initial_channel: int = 1024
    upsample_rates: Sequence[int] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    sampling_rate: int = 16_000

    @property
    def hop_length(self) -> int:
        return int(math.prod(self.upsample_rates))


class Conv1d(layers.Conv1d):
    """'Same'-padded dilated convolution, initialised as JAX's: uniform in
    +-1/sqrt(cin * k), zero bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1, *, device=None):
        super().__init__(cin, cout, k, stride=stride,
                         padding=(k - 1) * dilation // 2, dilation=dilation,
                         device=device)
        bound = 1.0 / math.sqrt(cin * k)
        nn.init.uniform_(self.weight, -bound, bound)


class ConvTranspose1d(nn.Module):
    """Stride-u transposed convolution (k >= u) with torch's implicit
    padding ``(k - u) // 2``; weight (cin, cout, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, *,
                 device=None):
        super().__init__()
        self.stride = stride
        self.pad = (k - stride) // 2
        bound = 1.0 / math.sqrt(cin * k)
        self.weight = nn.Parameter(torch.empty(cin, cout, k, device=device)
                                   .uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight, self.bias,
                                  stride=self.stride, padding=self.pad)


class ResBlock(nn.Module):
    """Pairs of a dilated and a plain convolution, each pair residual."""

    def __init__(self, ch: int, k: int, dilations: Sequence[int], *,
                 device=None):
        super().__init__()
        self.convs1 = nn.ModuleList([Conv1d(ch, ch, k, dilation=d,
                                            device=device)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([Conv1d(ch, ch, k, device=device)
                                     for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, 0.1)), 0.1))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or HiFiGANConfig()
        self.conv_pre = Conv1d(cfg.in_channels, cfg.upsample_initial_channel,
                               7, device=device)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = cfg.upsample_initial_channel
        for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, u, device=device))
            ch //= 2
            for rk, dil in zip(cfg.resblock_kernel_sizes,
                               cfg.resblock_dilations):
                self.resblocks.append(ResBlock(ch, rk, dil, device=device))
        self.conv_post = Conv1d(ch, 1, 7, device=device)
        self.num_kernels = len(cfg.resblock_kernel_sizes)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (b, frames, n_mels) -> waveform (b, samples), float32."""
        x = self.conv_pre(mel.float().transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, 0.1))
            blocks = self.resblocks[i * self.num_kernels:
                                    (i + 1) * self.num_kernels]
            acc = blocks[0](x)
            for blk in blocks[1:]:
                acc = acc + blk(x)
            x = acc / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.1))
        return torch.tanh(x)[:, 0]
