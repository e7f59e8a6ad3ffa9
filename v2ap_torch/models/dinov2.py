"""DINOv2 vision tower (the reference's ``video_encoder="dinov2"``), pixels ->
``pooler_output``.

Counterpart of ``v2ap_tpu/models/dinov2.py``: a biased conv patch embed, a
CLS token, learned position embeddings, pre-LN blocks with LayerScale on
both residual branches, the SwiGLU feed-forward of the giant variant (its
hidden width 2/3 of 4d, rounded up to a multiple of 8) or the GELU MLP of
the smaller ones, LayerNorm eps 1e-6; the output is the layer-normed CLS
token in float32.

Attention is the plain product the JAX package computes, not a flash
kernel: scores and softmax in float32 from the compute-dtype q and k, the
probabilities cast back to the compute dtype before P.V, whose float32
result is cast back too. On the card both bf16 products run on the tensor
cores with float32 accumulation and result; on the CPU the inputs are
widened to float32 (a float32 product of bf16 values is exact).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Conv2d, LayerNorm, Linear
from v2ap_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    hidden_size: int = 1536
    num_layers: int = 40
    num_heads: int = 24
    mlp_ratio: float = 4.0
    use_swiglu_ffn: bool = True        # giant uses SwiGLU; base/large use MLP
    image_size: int = 224              # serving crop
    patch_size: int = 14
    layerscale_value: float = 1.0
    layer_norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def swiglu_hidden(self) -> int:
        """HF Dinov2SwiGLUFFN: int(ratio*d * 2/3) rounded up to a multiple
        of 8."""
        hidden = int(self.hidden_size * self.mlp_ratio)
        return (int(hidden * 2 / 3) + 7) // 8 * 8


def dinov2_giant() -> Dinov2Config:
    return Dinov2Config()


def dinov2_tiny_test() -> Dinov2Config:
    return Dinov2Config(hidden_size=32, num_layers=2, num_heads=4,
                        image_size=28, patch_size=14, dtype="float32")


class Dinov2SwiGLU(nn.Module):
    def __init__(self, cfg: Dinov2Config, *, dtype, device=None):
        super().__init__()
        h = cfg.swiglu_hidden
        self.weights_in = Linear(cfg.hidden_size, 2 * h, dtype=dtype,
                                 device=device)
        self.weights_out = Linear(h, cfg.hidden_size, dtype=dtype,
                                  device=device)

    def forward(self, x):
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(x1) * x2)


class Dinov2MLP(nn.Module):
    def __init__(self, cfg: Dinov2Config, *, dtype, device=None):
        super().__init__()
        h = int(cfg.hidden_size * cfg.mlp_ratio)
        self.fc1 = Linear(cfg.hidden_size, h, dtype=dtype, device=device)
        self.fc2 = Linear(h, cfg.hidden_size, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) as float32: on the card, bf16 inputs go to
    the tensor cores with float32 accumulation and a float32 result
    (``out_dtype``), as JAX's ``preferred_element_type=float32``; otherwise
    the inputs are widened to float32 first (the same products, exact)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        lead = a.shape[:-2]
        return torch.bmm(a.reshape(-1, *a.shape[-2:]),
                         b.reshape(-1, *b.shape[-2:]),
                         out_dtype=torch.float32).unflatten(0, lead)
    return torch.matmul(a.float(), b.float())


class Dinov2Attention(nn.Module):
    def __init__(self, cfg: Dinov2Config, *, dtype, device=None):
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

        def split(t):                   # (b, n, d) -> (b, h, n, dh)
            return t.unflatten(-1, (self.heads, self.dh)).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        s = _matmul_f32(q, k.transpose(-1, -2)) * (self.dh ** -0.5)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        out = _matmul_f32(p, v).to(x.dtype)
        return self.o(out.transpose(1, 2).reshape(b, n, d))


class Dinov2Block(nn.Module):
    def __init__(self, cfg: Dinov2Config, *, dtype, device=None):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = LayerNorm(d, eps, device=device)
        self.attn = Dinov2Attention(cfg, dtype=dtype, device=device)
        self.scale1 = nn.Parameter(torch.full((d,), cfg.layerscale_value,
                                              device=device))
        self.norm2 = LayerNorm(d, eps, device=device)
        self.mlp = (Dinov2SwiGLU(cfg, dtype=dtype, device=device)
                    if cfg.use_swiglu_ffn
                    else Dinov2MLP(cfg, dtype=dtype, device=device))
        self.scale2 = nn.Parameter(torch.full((d,), cfg.layerscale_value,
                                              device=device))

    def forward(self, x):
        x = x + self.attn(self.norm1(x).to(x.dtype)) * self.scale1.to(x.dtype)
        return x + self.mlp(self.norm2(x).to(x.dtype)) * self.scale2.to(x.dtype)


class Dinov2Model(nn.Module):
    """pixel_values (b, H, W, 3) -> pooler_output (b, hidden_size) float32:
    the layer-normed CLS token, as HF ``Dinov2Model().pooler_output``."""

    def __init__(self, cfg: Dinov2Config | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg = cfg or dinov2_giant()
        dtype = getattr(torch, cfg.dtype)
        self.dtype = dtype
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Conv2d(3, d, p, stride=p, dtype=dtype,
                                  device=device)
        self.cls_token = nn.Parameter(torch.randn(d, device=device) * 0.02)
        self.position_embedding = nn.Parameter(
            torch.randn(cfg.num_patches + 1, d, device=device) * 0.02)
        self.blocks = nn.ModuleList([Dinov2Block(cfg, dtype=dtype,
                                                 device=device)
                                     for _ in range(cfg.num_layers)])
        self.layernorm = LayerNorm(d, cfg.layer_norm_eps, device=device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b = pixel_values.shape[0]
        dt = self.dtype
        patches = self.patch_embed(pixel_values.to(dt).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)     # row-major patches
        cls = self.cls_token.to(dt)[None, None].expand(b, 1,
                                                       self.cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.to(dt)[None]
        for blk in self.blocks:
            x = blk(x)
        # the final LayerNorm is per token: only the CLS token's is returned
        return self.layernorm(x[:, 0]).float()


# ------------------------------------------------------------- preprocessing

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
