"""Plain float32 reference of EnCodec's 24 kHz decoder (SEANet: causal
convolutions with reflect padding, a residual two-layer LSTM written out
step by step, transposed convolutions trimmed on the right):
latents (b, n, 128) -> waveform (b, n * 320)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _reflect(x, left, right):
    n = x.shape[-1]
    extra = 0
    if n <= max(left, right):
        extra = max(left, right) - n + 1
        x = F.pad(x, (0, extra))
    out = F.pad(x, (left, right), mode="reflect")
    return out[..., : out.shape[-1] - extra] if extra else out


class CausalConv1d(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, dilation=1, *,
                 device=None):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.kernel_eff = (kernel - 1) * dilation + 1
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel,
                                               device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, device=device),
                                 requires_grad=False)

    def forward(self, x):
        pad = self.kernel_eff - self.stride
        n = x.shape[-1]
        frames = (n - self.kernel_eff + pad) / self.stride + 1
        ideal = (math.ceil(frames) - 1) * self.stride + self.kernel_eff - pad
        x = _reflect(x, pad, max(ideal - n, 0))
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        dilation=self.dilation)


class CausalConvTranspose1d(nn.Module):
    def __init__(self, cin, cout, kernel, stride, *, device=None):
        super().__init__()
        self.stride, self.kernel = stride, kernel
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel,
                                               device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, device=device),
                                 requires_grad=False)

    def forward(self, x):
        out = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride)
        return out[..., : out.shape[-1] - (self.kernel - self.stride)]


class ResnetBlock1d(nn.Module):
    def __init__(self, dim, compress, kernel, dilation, *, device=None):
        super().__init__()
        hidden = dim // compress
        self.block = nn.ModuleList([
            CausalConv1d(dim, hidden, kernel, dilation=dilation,
                         device=device),
            CausalConv1d(hidden, dim, 1, device=device)])
        self.shortcut = CausalConv1d(dim, dim, 1, device=device)

    def forward(self, x):
        h = x
        for conv in self.block:
            h = conv(F.elu(h))
        return self.shortcut(x) + h


class _LSTMWeights(nn.Module):
    """The parameter layout of a stacked LSTM (gate order i, f, g, o)."""

    def __init__(self, dim, layers, *, device=None):
        super().__init__()
        self.layers = layers
        for k in range(layers):
            for name, shape in ((f"weight_ih_l{k}", (4 * dim, dim)),
                                (f"weight_hh_l{k}", (4 * dim, dim)),
                                (f"bias_ih_l{k}", (4 * dim,)),
                                (f"bias_hh_l{k}", (4 * dim,))):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(*shape, device=device), requires_grad=False))


class ResidualLSTM(nn.Module):
    def __init__(self, dim, layers, *, device=None):
        super().__init__()
        self.lstm = _LSTMWeights(dim, layers, device=device)

    def forward(self, x):                                   # (b, c, t)
        y = x.transpose(1, 2)
        for k in range(self.lstm.layers):
            w_ih = getattr(self.lstm, f"weight_ih_l{k}")
            w_hh = getattr(self.lstm, f"weight_hh_l{k}")
            gx = y @ w_ih.T + getattr(self.lstm, f"bias_ih_l{k}") \
                + getattr(self.lstm, f"bias_hh_l{k}")
            b, t, _ = y.shape
            h = y.new_zeros(b, w_hh.shape[1])
            c = torch.zeros_like(h)
            outs = []
            for s in range(t):
                i, f, g, o = (gx[:, s] + h @ w_hh.T).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(h)
            y = torch.stack(outs, 1)
        return y.transpose(1, 2) + x


class EncodecDecoder(nn.Module):
    def __init__(self, c: dict, *, device=None):
        super().__init__()
        if (not c["use_causal_conv"] or c["pad_mode"] != "reflect"
                or c["trim_right_ratio"] != 1.0
                or c["num_residual_layers"] != 1):
            raise ValueError("the reference decoder is the causal 24 kHz one")
        ratios = tuple(c["upsampling_ratios"])
        scale = 2 ** len(ratios)
        nf = c["num_filters"]
        p = dict(device=device)
        layers = [CausalConv1d(c["hidden_size"], scale * nf, c["kernel_size"],
                               **p),
                  ResidualLSTM(scale * nf, c["num_lstm_layers"], **p)]
        for r in ratios:
            cur = scale * nf
            layers += [nn.ELU(), CausalConvTranspose1d(cur, cur // 2, 2 * r, r,
                                                       **p),
                       ResnetBlock1d(cur // 2, c["compress"],
                                     c["residual_kernel_size"], 1, **p)]
            scale //= 2
        layers += [nn.ELU(), CausalConv1d(nf, c["audio_channels"],
                                          c["last_kernel_size"], **p)]
        self.layers = nn.ModuleList(layers)

    def forward(self, latents):
        x = latents.transpose(1, 2)
        for layer in self.layers:
            x = layer(x)
        return x[:, 0]
