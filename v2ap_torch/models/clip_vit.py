"""CLIP vision tower with projection (ViT-bigG, ViT-L/14-336), pixels ->
image embeds.

Counterpart of ``v2ap_tpu/models/clip_vit.py``: conv patch embed (no bias),
class token + position embeddings, pre-layernorm blocks, exact GELU (bigG)
or quick GELU (ViT-L), and the ``visual_projection`` of the layer-normed
class token. Every attention layer runs the hand-written flash kernel
(``flash_attention``, K2) on its tokens as they are: bigG's 257 at head
dim 104, ViT-L/336's 577 at head dim 64; nothing is padded.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch import native
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


def clip_vit_l_336() -> CLIPVisionConfig:
    """openai/clip-vit-large-patch14-336 (the reference's clip_vit2 option)."""
    return CLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                            num_layers=24, num_heads=16, image_size=336,
                            patch_size=14, projection_dim=768,
                            hidden_act="quick_gelu")


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
        return self.o(out.to(x.dtype).transpose(1, 2).reshape(b, n, -1))


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


_PRECISION_BITS = 22       # Pillow's fixed point for 8-bit resampling


def _bicubic(x: float) -> float:
    """Pillow's bicubic filter (a = -0.5)."""
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return 0.0


@functools.lru_cache(maxsize=64)
def _resample_matrix(in_size: int, out_full: int, offset: int,
                     n: int) -> np.ndarray:
    """Pillow's fixed-point bicubic coefficients (Resample.c,
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc``) of output pixels
    ``offset .. offset + n`` of a resize from ``in_size`` to ``out_full``,
    as a read-only (n, in_size) int64 matrix, zero outside each pixel's
    window; built once per geometry."""
    scale = in_size / out_full
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((n, in_size), np.int64)
    for i in range(n):
        center = (offset + i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_bicubic((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax - xmin)]
        total = sum(w)
        for x, wx in enumerate(w):
            v = wx / total * (1 << _PRECISION_BITS)
            mat[i, xmin + x] = int(v - 0.5 if v < 0 else v + 0.5)
    mat.setflags(write=False)
    return mat


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's ``clip8`` on float64 sums of integers: (acc + 2^21) >> 22,
    clipped to [0, 255] (exact: |acc| < 2^31)."""
    half = float(1 << (_PRECISION_BITS - 1))
    return torch.floor((acc + half) / float(1 << _PRECISION_BITS)).clamp_(
        0.0, 255.0)


# float64 bytes of frames that one horizontal pass converts at a time: a
# 64-frame 1080p chunk would take 3.2 GB at once
_F64_FRAME_BYTES = 1 << 29


def resize_center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 RGB (t, H, W, 3) -> (t, size, size, 3) uint8 on the frames'
    device: the shortest edge resized to ``size`` (bicubic), then the
    center crop, bit-equal to PIL's ``Image.resize(..., BICUBIC)`` +
    ``crop`` (and to the JAX package's native resampler). Both passes, the
    horizontal one first and rounded to uint8 as in PIL, are float64
    products of integers below 2^31: exact on any device, in any summation
    order. The frames go through in groups of at most 512 MiB of float64."""
    t, h, w, _ = frames.shape
    short = min(h, w)
    nw, nh = round(w * size / short), round(h * size / short)
    left, top = (nw - size) // 2, (nh - size) // 2
    dev, f64 = frames.device, torch.float64
    mh = torch.tensor(_resample_matrix(w, nw, left, size), dtype=f64,
                      device=dev)
    mv = torch.tensor(_resample_matrix(h, nh, top, size), dtype=f64,
                      device=dev)
    group = max(1, _F64_FRAME_BYTES // (h * w * 3 * 8))
    out = []
    for i in range(0, t, group):
        # (g, h, 3, w) made contiguous in uint8, so the float64 copy is the
        # only large one; rows of the product are pixels, columns outputs
        x = frames[i: i + group].permute(0, 1, 3, 2).contiguous().to(f64)
        tmp = _clip8(x @ mh.T)                              # (g, h, 3, size)
        tmp = tmp.permute(0, 2, 3, 1).contiguous()          # (g, 3, size, h)
        y = _clip8(tmp @ mv.T)                              # (g, 3, size, r)
        out.append(y.permute(0, 3, 2, 1).to(torch.uint8))   # (g, r, size, 3)
    return torch.cat(out).contiguous()


def crop_to_tower(px: torch.Tensor, image_size: int) -> torch.Tensor:
    """A tower's geometry on uint8 (t, H, W, 3) frames: unchanged when they
    are ``image_size`` square already (PIL's resize to the same size is an
    unchanged copy), else ``resize_center_crop``."""
    if tuple(px.shape[1:3]) == (image_size, image_size):
        return px
    return resize_center_crop(px, image_size)


def preprocess_frames(frames: np.ndarray, image_size: int = 224,
                      normalize: bool = False) -> np.ndarray:
    """uint8 RGB frames (t, H, W, 3) -> (t, S, S, 3) on the host, through
    the host library's ``clip_preprocess_batch`` (the JAX package's route):
    the geometry of ``resize_center_crop``, bit-equal to it and to PIL.
    With ``normalize`` the pixels are rescaled by 1/255 and normalised by
    CLIP's mean and std to float32; else they stay uint8. Frames the
    library does not take (not RGB) go through ``resize_center_crop`` on
    the CPU."""
    out = native.clip_preprocess_batch(frames, image_size)
    if out is None:
        out = resize_center_crop(torch.from_numpy(np.ascontiguousarray(
            frames, np.uint8)), image_size).numpy()
    if not normalize:
        return out
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    return (out.astype(np.float32) / 255.0 - mean) / std


def host_crop_to_tower(frames: np.ndarray, image_size: int) -> np.ndarray:
    """``crop_to_tower`` on the host (the YUV wire's route): unchanged when
    the frames are ``image_size`` square already, else
    ``preprocess_frames``."""
    if tuple(frames.shape[1:3]) == (image_size, image_size):
        return frames
    return preprocess_frames(frames, image_size)


def device_normalize(px: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 pixels -> normalised float32 on px's device: rescaled by 1/255,
    then CLIPImageProcessor's (or the tower's) mean and std."""
    x = px.float() / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=px.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=px.device)
    return (x - mean) / std


# ---------------------------------------------------------------- YUV 4:2:0
# The pixel-shipping mode ``V2AP_SHIP_YUV420``: tower-resolution frames
# pack on the host to full-range BT.601 YUV with 2x2-averaged chroma (1.5
# bytes a pixel instead of 3) and unpack on the device before the tower.
# The forward and inverse transforms are exactly consistent, so the loss is
# the uint8 rounding and the chroma averaging only.

def pack_yuv420(px: np.ndarray):
    """uint8 RGB (t, S, S, 3), S even -> (y: (t, S, S) uint8, uv: (t, 2,
    S/2, S/2) uint8), on the host: the host library's fixed-point pack, the
    JAX package's default, bit-equal to it; other shapes go through
    ``pack_yuv420_plain``, within 1 LSB of it."""
    out = native.pack_yuv420(px)
    return pack_yuv420_plain(px) if out is None else out


def pack_yuv420_plain(px: np.ndarray):
    """The plain version of ``pack_yuv420``: the JAX package's numpy path,
    in float32."""
    f = px.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 + (b - y) / 1.772
    cr = 128.0 + (r - y) / 1.402
    t, s, _ = y.shape
    h = s // 2

    def sub(c):
        return c.reshape(t, h, 2, h, 2).mean(axis=(2, 4))

    y8 = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    uv = np.stack([sub(cb), sub(cr)], axis=1)
    uv8 = np.clip(uv + 0.5, 0, 255).astype(np.uint8)
    return y8, uv8


def unpack_yuv420(y: torch.Tensor, uv: torch.Tensor, mean, std
                  ) -> torch.Tensor:
    """The device-side inverse of ``pack_yuv420`` and the tower's
    normalisation: (t, S, S) uint8 + (t, 2, S/2, S/2) uint8 -> (t, S, S, 3)
    normalised float32 on their device."""
    yf = y.float()
    uvf = uv.float() - 128.0
    # nearest 2x upsample of the chroma planes
    uvf = uvf.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    cb, cr = uvf[:, 0], uvf[:, 1]
    r = yf + 1.402 * cr
    b = yf + 1.772 * cb
    g = (yf - 0.299 * r - 0.114 * b) / 0.587
    x = (torch.stack([r, g, b], dim=-1) / 255.0).clamp(0.0, 1.0)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=y.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=y.device)
    return (x - mean) / std
