"""CLIP vision tower with projection (ViT-bigG), pixels -> image embeds.

Counterpart of ``v2ap_tpu/models/clip_vit.py``: conv patch embed (no bias),
class token + position embeddings, pre-layernorm blocks, exact GELU, and the
``visual_projection`` of the layer-normed class token. Every attention
layer runs the hand-written flash kernel (``flash_attention``, K2) on its
257 tokens and head dim 104 as they are; nothing is padded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.flash_attention import flash_attention
from v2ap_torch.ops.layers import LayerNorm, Linear, lecun_normal_
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1664
    intermediate_size: int = 8192
    num_layers: int = 48
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1280
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"        # bigG: gelu; openai ViT-L: quick_gelu
    dtype: str = "bfloat16"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_vit_bigg() -> CLIPVisionConfig:
    """IP-Adapter SDXL image encoder (ViT-bigG-14, laion2b)."""
    return CLIPVisionConfig()


def clip_tiny_test() -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                            num_heads=4, image_size=28, patch_size=14,
                            projection_dim=16, dtype="float32")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class PatchEmbed(nn.Module):
    """nnx.Conv with stride == kernel == patch, no bias, on NHWC pixels."""

    def __init__(self, cfg: CLIPVisionConfig, *, dtype, device=None):
        super().__init__()
        p = cfg.patch_size
        self.patch = p
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cfg.hidden_size, 3, p, p,
                                               device=device))
        lecun_normal_(self.weight, 3 * p * p)

    def forward(self, px: torch.Tensor) -> torch.Tensor:
        # (b, H, W, 3) -> (b, (H/p)*(W/p), hidden), patches in row-major order
        x = px.to(self.dtype).permute(0, 3, 1, 2)
        out = F.conv2d(x, self.weight.to(self.dtype), stride=self.patch)
        return out.flatten(2).transpose(1, 2)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, dtype, device=None):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
                          device=device)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype,
                          device=device)
        self.act = cfg.hidden_act

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, dtype, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.q = Linear(d, d, dtype=dtype, device=device)
        self.k = Linear(d, d, dtype=dtype, device=device)
        self.v = Linear(d, d, dtype=dtype, device=device)
        self.o = Linear(d, d, dtype=dtype, device=device)
        self.heads = cfg.num_heads
        self.dh = d // cfg.num_heads

    def forward(self, x):
        b, n, d = x.shape

        def split(t):                   # (b, n, d) -> (b, h, n, dh) view
            return t.unflatten(-1, (self.heads, self.dh)).transpose(1, 2)

        out = flash_attention(split(self.q(x)), split(self.k(x)),
                              split(self.v(x)), scale=self.dh ** -0.5)
        return self.o(out.to(x.dtype).transpose(1, 2).reshape(b, n, d))


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, dtype, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.attn = CLIPAttention(cfg, dtype=dtype, device=device)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device)
        self.mlp = CLIPMLP(cfg, dtype=dtype, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x).to(x.dtype))
        return x + self.mlp(self.ln2(x).to(x.dtype))


class CLIPVisionModel(nn.Module):
    """pixel_values (b, H, W, 3) -> projected image embeds (b, projection_dim)."""

    def __init__(self, cfg: CLIPVisionConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or clip_vit_bigg()
        dtype = getattr(torch, cfg.dtype)
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg, dtype=dtype, device=device)
        self.class_embedding = nn.Parameter(
            torch.randn(cfg.hidden_size, device=device) * 0.02)
        self.position_embedding = nn.Parameter(
            torch.randn(cfg.num_patches + 1, cfg.hidden_size, device=device)
            * 0.02)
        eps = cfg.layer_norm_eps
        self.pre_layernorm = LayerNorm(cfg.hidden_size, eps, device=device)
        self.blocks = nn.ModuleList([CLIPBlock(cfg, dtype=dtype, device=device)
                                     for _ in range(cfg.num_layers)])
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps, device=device)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim,
                                        bias=False, dtype=dtype, device=device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        dt = self.dtype
        patches = self.patch_embed(pixel_values)
        cls = self.class_embedding.to(dt)[None, None].expand(
            b, 1, self.cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.to(dt)[None]
        x = self.pre_layernorm(x).to(dt)
        for blk in self.blocks:
            x = blk(x)
        pooled = self.post_layernorm(x[:, 0]).to(dt)
        return self.visual_projection(pooled).float()


# ------------------------------------------------------------- preprocessing

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_frames(frames: np.ndarray, image_size: int = 224, mean=None,
                      std=None, normalize: bool = True) -> np.ndarray:
    """uint8 RGB frames (t, H, W, 3) -> (t, S, S, 3), as CLIPImageProcessor:
    resize the shortest edge (bicubic), center crop, rescale 1/255,
    normalize. ``normalize=False`` returns uint8 geometry only.

    Frames already ``image_size`` square pass through unchanged (PIL's
    resize to the same size returns an unchanged copy), so that path needs
    no PIL; other sizes import PIL here.
    """
    mean = np.asarray(mean if mean is not None else CLIP_MEAN, np.float32)
    std = np.asarray(std if std is not None else CLIP_STD, np.float32)
    frames = np.asarray(frames)
    if frames.shape[1:3] == (image_size, image_size):
        out = frames.astype(np.uint8, copy=True)
    else:
        from PIL import Image

        out = np.empty((len(frames), image_size, image_size, 3), np.uint8)
        for i, frame in enumerate(frames):
            img = Image.fromarray(frame)
            w, h = img.size
            short = min(w, h)
            nw, nh = round(w * image_size / short), round(h * image_size / short)
            img = img.resize((nw, nh), Image.BICUBIC)
            left, top = (nw - image_size) // 2, (nh - image_size) // 2
            out[i] = np.asarray(img.crop((left, top, left + image_size,
                                          top + image_size)), np.uint8)
    if not normalize:
        return out
    return (out.astype(np.float32) / 255.0 - mean) / std


def device_normalize(px: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 pixels -> normalised float32 on px's device (the tower-side
    counterpart of ``preprocess_frames(normalize=False)``)."""
    x = px.float() / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=px.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=px.device)
    return (x - mean) / std
