"""ConvNeXt-XXLarge CLIP image tower (the reference's
``video_encoder="clip_convnext"``), pixels -> image embedding.

Counterpart of ``v2ap_tpu/models/convnext.py``:

  4x4/4 stem conv + LN -> 4 stages of (3, 4, 30, 3) ConvNeXt blocks (7x7
  depthwise conv, LN, 4x pointwise MLP with exact GELU, LayerScale) with a
  LN + 2x2/2 conv between stages -> global average pool -> LN (the trunk's
  head norm) -> open_clip's MLP projection head (hidden 2 x embed_dim).

Activations stay (b, h, w, c), as in JAX: LayerNorm and the pointwise
linears act on the last axis, and each convolution takes the NCHW view of
that memory (channels-last, which cuDNN runs as such). The convolutions are
``torch.nn.functional.conv2d``: the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Conv2d, LayerNorm, Linear
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ConvNextConfig:
    depths: Tuple[int, ...] = (3, 4, 30, 3)
    hidden_sizes: Tuple[int, ...] = (384, 768, 1536, 3072)   # xxlarge
    image_size: int = 256
    embed_dim: int = 1024            # CLIP projection width
    layer_scale_init: float = 1e-6
    layer_norm_eps: float = 1e-6
    dtype: str = "bfloat16"


def convnext_xxlarge() -> ConvNextConfig:
    return ConvNextConfig()


def convnext_tiny_test() -> ConvNextConfig:
    return ConvNextConfig(depths=(1, 1, 2, 1), hidden_sizes=(8, 16, 32, 64),
                          image_size=32, embed_dim=24, dtype="float32")


def _conv_nhwc(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over (b, h, w, c) activations, (b, h', w', c') out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, cfg: ConvNextConfig, *, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, cfg.layer_norm_eps, device=device)
        self.pwconv1 = Linear(dim, 4 * dim, **kw)
        self.pwconv2 = Linear(4 * dim, dim, **kw)
        self.scale = nn.Parameter(torch.full((dim,), cfg.layer_scale_init,
                                             device=device))

    def forward(self, x):                       # (b, h, w, c)
        h = self.norm(_conv_nhwc(self.dwconv, x)).to(x.dtype)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + h * self.scale.to(x.dtype)


class ConvNextDownsample(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: ConvNextConfig, *, dtype,
                 device=None):
        super().__init__()
        self.norm = LayerNorm(cin, cfg.layer_norm_eps, device=device)
        self.conv = Conv2d(cin, cout, 2, stride=2, dtype=dtype, device=device)

    def forward(self, x):
        return _conv_nhwc(self.conv, self.norm(x).to(x.dtype))


class ConvNextCLIP(nn.Module):
    """pixel_values (b, H, W, 3) -> image embedding (b, embed_dim) float32."""

    def __init__(self, cfg: ConvNextConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or convnext_xxlarge()
        dtype = getattr(torch, cfg.dtype)
        self.dtype = dtype
        dims = cfg.hidden_sizes
        eps = cfg.layer_norm_eps
        kw = dict(dtype=dtype, device=device)
        self.stem_conv = Conv2d(3, dims[0], 4, stride=4, **kw)
        self.stem_norm = LayerNorm(dims[0], eps, device=device)
        self.downsamples = nn.ModuleList([
            ConvNextDownsample(dims[i], dims[i + 1], cfg, **kw)
            for i in range(3)])
        self.stages = nn.ModuleList([
            nn.ModuleList([ConvNextBlock(dims[s], cfg, **kw)
                           for _ in range(cfg.depths[s])])
            for s in range(4)])
        self.head_norm = LayerNorm(dims[-1], eps, device=device)
        self.head_fc1 = Linear(dims[-1], 2 * cfg.embed_dim, **kw)
        self.head_fc2 = Linear(2 * cfg.embed_dim, cfg.embed_dim, **kw)

    def pooled(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Global-average-pooled, layer-normed trunk features (b, dims[-1])
        float32 (HF ``ConvNextModel().pooler_output``)."""
        dt = self.dtype
        x = self.stem_norm(_conv_nhwc(self.stem_conv,
                                      pixel_values.to(dt))).to(dt)
        for s, blocks in enumerate(self.stages):
            if s > 0:
                x = self.downsamples[s - 1](x)
            for blk in blocks:
                x = blk(x)
        return self.head_norm(x.mean(dim=(1, 2))).float()

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        pooled = self.pooled(pixel_values).to(self.dtype)
        return self.head_fc2(F.gelu(self.head_fc1(pooled))).float()
