"""EnCodec 24 kHz codec (SEANet conv stacks + LSTM): waveform -> latents
(the training targets) and latents -> waveform (the vocoder), and the
residual vector quantizer (latents <-> codes).

Counterpart of ``v2ap_tpu/models/encodec.py``, with the same
causal-padding semantics. Public functions keep the JAX layouts ((b, t)
waveform, (b, n, 128) latents, (q, b, n) codes); inside, layers run on
PyTorch's (b, c, t). Float32 throughout. Layer indices of the encoder and
the decoder match the JAX stacks' (ELU placeholders included), so weight
paths agree (``v2ap_torch.utils.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    sampling_rate: int = 24_000
    audio_channels: int = 1
    hidden_size: int = 128
    num_filters: int = 32
    num_residual_layers: int = 1
    upsampling_ratios: Sequence[int] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    compress: int = 2
    num_lstm_layers: int = 2
    trim_right_ratio: float = 1.0
    codebook_size: int = 1024
    num_quantizers: int = 32

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsampling_ratios))


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the time axis of (b, c, t); reflect padding of an input shorter
    than the pad zero-extends first, as the reference codec does."""
    if mode in ("zero", "constant"):
        return F.pad(x, (left, right))
    length = x.shape[-1]
    max_pad = max(left, right)
    extra = 0
    if length <= max_pad:
        extra = max_pad - length + 1
        x = F.pad(x, (0, extra))
    out = F.pad(x, (left, right), mode="reflect")
    if extra:
        out = out[..., : out.shape[-1] - extra]
    return out


class CausalConv1d(nn.Module):
    """Conv1d with EnCodec's causal / asymmetric padding; weight (out, in, k)."""

    def __init__(self, cfg: EncodecConfig, cin: int, cout: int, kernel: int,
                 stride: int = 1, dilation: int = 1, *, device=None):
        super().__init__()
        self.causal = cfg.use_causal_conv
        self.pad_mode = cfg.pad_mode
        self.stride = stride
        self.dilation = dilation
        self.kernel_eff = (kernel - 1) * dilation + 1
        self.padding_total = self.kernel_eff - stride
        k = 1.0 / math.sqrt(cin * kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel,
                                               device=device).uniform_(-k, k))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        length = x.shape[-1]
        n_frames = (length - self.kernel_eff + self.padding_total) / self.stride + 1
        ideal = ((math.ceil(n_frames) - 1) * self.stride + self.kernel_eff
                 - self.padding_total)
        extra = max(ideal - length, 0)
        if self.causal:
            x = _pad1d(x, self.padding_total, extra, self.pad_mode)
        else:
            right = self.padding_total // 2
            x = _pad1d(x, self.padding_total - right, right + extra,
                       self.pad_mode)
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        dilation=self.dilation)


class CausalConvTranspose1d(nn.Module):
    """ConvTranspose1d trimmed to EnCodec's causal length; weight (cin, cout, k)."""

    def __init__(self, cfg: EncodecConfig, cin: int, cout: int, kernel: int,
                 stride: int = 1, *, device=None):
        super().__init__()
        self.causal = cfg.use_causal_conv
        self.stride = stride
        self.kernel_size = kernel
        self.trim_right_ratio = cfg.trim_right_ratio
        k = 1.0 / math.sqrt(cin * kernel)
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel,
                                               device=device).uniform_(-k, k))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride)
        padding_total = self.kernel_size - self.stride
        if self.causal:
            right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            right = padding_total // 2
        left = padding_total - right
        return out[..., left: out.shape[-1] - right]


class ResnetBlock1d(nn.Module):
    def __init__(self, cfg: EncodecConfig, dim: int, dilations: Sequence[int],
                 *, device=None):
        super().__init__()
        hidden = dim // cfg.compress
        kernels = (cfg.residual_kernel_size, 1)
        self.block = nn.ModuleList()
        for i, (k, d) in enumerate(zip(kernels, dilations)):
            cin = dim if i == 0 else hidden
            cout = dim if i == len(kernels) - 1 else hidden
            self.block.append(CausalConv1d(cfg, cin, cout, k, dilation=d,
                                           device=device))
        self.shortcut = CausalConv1d(cfg, dim, dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in self.block:
            h = conv(F.elu(h))
        return self.shortcut(x) + h


class ResidualLSTM(nn.Module):
    """Multi-layer LSTM over time with a residual connection (gate order
    i, f, g, o, as the JAX package's scan)."""

    def __init__(self, dim: int, num_layers: int, *, device=None):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers, batch_first=True,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.transpose(1, 2))
        return y.transpose(1, 2) + x


class EncodecEncoder(nn.Module):
    """waveform (b, 1, t) -> latents (b, 128, t / 320)."""

    def __init__(self, cfg: EncodecConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        layers = [CausalConv1d(cfg, cfg.audio_channels, cfg.num_filters,
                               cfg.kernel_size, device=device)]
        scaling = 1
        for ratio in reversed(tuple(cfg.upsampling_ratios)):
            cur = scaling * cfg.num_filters
            layers += [ResnetBlock1d(cfg, cur,
                                     (cfg.dilation_growth_rate ** j, 1),
                                     device=device)
                       for j in range(cfg.num_residual_layers)]
            layers += [nn.ELU(),
                       CausalConv1d(cfg, cur, cur * 2, ratio * 2,
                                    stride=ratio, device=device)]
            scaling *= 2
        layers += [ResidualLSTM(scaling * cfg.num_filters,
                                cfg.num_lstm_layers, device=device),
                   nn.ELU(),
                   CausalConv1d(cfg, scaling * cfg.num_filters,
                                cfg.hidden_size, cfg.last_kernel_size,
                                device=device)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class EncodecDecoder(nn.Module):
    """latents (b, 128, n) -> waveform (b, 1, n*320). Layer indices match
    the JAX decoder's (ELU placeholders included), so weight paths agree."""

    def __init__(self, cfg: EncodecConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        scaling = int(2 ** len(tuple(cfg.upsampling_ratios)))
        layers = [CausalConv1d(cfg, cfg.hidden_size, scaling * cfg.num_filters,
                               cfg.kernel_size, device=device),
                  ResidualLSTM(scaling * cfg.num_filters, cfg.num_lstm_layers,
                               device=device)]
        for ratio in tuple(cfg.upsampling_ratios):
            cur = scaling * cfg.num_filters
            layers += [nn.ELU(),
                       CausalConvTranspose1d(cfg, cur, cur // 2, ratio * 2,
                                             stride=ratio, device=device)]
            layers += [ResnetBlock1d(cfg, cur // 2,
                                     (cfg.dilation_growth_rate ** j, 1),
                                     device=device)
                       for j in range(cfg.num_residual_layers)]
            scaling //= 2
        layers += [nn.ELU(),
                   CausalConv1d(cfg, cfg.num_filters, cfg.audio_channels,
                                cfg.last_kernel_size, device=device)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class ResidualVQ(nn.Module):
    """Residual vector quantizer: ``num_quantizers`` codebooks of
    ``codebook_size`` vectors, each quantizing what the ones before left."""

    def __init__(self, cfg: EncodecConfig, *, device=None):
        super().__init__()
        self.codebooks = nn.Parameter(torch.randn(
            cfg.num_quantizers, cfg.codebook_size, cfg.hidden_size,
            device=device))

    def encode(self, latents: torch.Tensor, num_quantizers: int
               ) -> torch.Tensor:
        """latents (b, n, d) -> codes (q, b, n): each codebook's nearest
        vector by the squared distance |r|^2 - 2 r.c + |c|^2 (the first on
        a tie), subtracted from the residual r."""
        residual = latents.float()
        codes = []
        for q in range(num_quantizers):
            cb = self.codebooks[q]                                   # (K, d)
            d2 = ((residual ** 2).sum(-1, keepdim=True)
                  - 2.0 * residual @ cb.T + (cb ** 2).sum(-1)[None, None, :])
            idx = d2.argmin(dim=-1)                                  # (b, n)
            residual = residual - cb[idx]
            codes.append(idx)
        return torch.stack(codes)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (q, b, n) -> latents (b, n, d): the sum of the codebooks'
        vectors."""
        out = 0.0
        for q in range(codes.shape[0]):
            out = out + self.codebooks[q][codes[q]]
        return out


class EncodecModel(nn.Module):
    """``encode`` turns audio into latents, ``decode`` latents into audio;
    ``quantizer`` maps latents to codes and back."""

    def __init__(self, cfg: EncodecConfig | None = None, *, device=None):
        super().__init__()
        self.cfg = cfg or EncodecConfig()
        device = resolve_device(device)
        self.encoder = EncodecEncoder(self.cfg, device=device)
        self.decoder = EncodecDecoder(self.cfg, device=device)
        self.quantizer = ResidualVQ(self.cfg, device=device)

    def encode(self, waveform: torch.Tensor) -> torch.Tensor:
        """(b, t) or (b, t, 1) -> (b, t / 320, 128) continuous latents."""
        if waveform.ndim == 3:
            waveform = waveform[..., 0]
        return self.encoder(waveform.float()[:, None]).transpose(1, 2)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, n, 128) -> (b, t) waveform."""
        return self.decoder(latents.float().transpose(1, 2))[:, 0]
