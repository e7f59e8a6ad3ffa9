"""Plain float32 references of the per-frame video towers and their
geometry: CLIP ViT-bigG/14 and ViT-L/14-336 (pre-norm ViT with a projected
class token), DINOv2-giant (SwiGLU, layer scale, normed class token) and
ConvNeXt-XXLarge (open_clip head), each after Pillow's bicubic resize of
the shortest edge and a centre crop, and its normalisation. Under int8
towers (``reference.nn.int8_linears``) every ``Linear`` here runs AQT's int8
product: ViT-bigG's q, k, v, o, fc1 and fc2 in each layer and its
``visual_projection``, as the served ``set_int8_towers`` sets them."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import (Conv2d, LayerNorm, Linear, fp8,
                                    softmax_attention)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# --------------------------------------------------------------- geometry
_BITS = 22                      # Pillow's fixed point for 8-bit images


def _cubic(x: float) -> float:
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return 0.0


def _coefficients(in_size: int, out_size: int, first: int, n: int):
    """Pillow's integer bicubic weights of output pixels first..first+n of
    a resize in_size -> out_size, as an (n, in_size) float64 matrix."""
    scale = in_size / out_size
    support = 2.0 * max(scale, 1.0)
    mat = torch.zeros(n, in_size, dtype=torch.float64)
    for i in range(n):
        centre = (first + i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), in_size)
        w = [_cubic((x + lo - centre + 0.5) / max(scale, 1.0))
             for x in range(hi - lo)]
        total = sum(w)
        for x, wx in enumerate(w):
            v = wx / total * (1 << _BITS)
            mat[i, lo + x] = float(int(v - 0.5 if v < 0 else v + 0.5))
    return mat


def _round_clip(acc):
    return torch.floor((acc + float(1 << (_BITS - 1))) / float(1 << _BITS)
                       ).clamp(0.0, 255.0)


def resize_center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (t, H, W, 3) -> uint8 (t, size, size, 3): shortest edge to
    ``size`` by Pillow's bicubic (horizontal pass first, rounded to 8 bits),
    then the centre crop. Integer sums below 2^31 in float64: exact."""
    t, h, w, _ = frames.shape
    if (h, w) == (size, size):
        return frames
    short = min(h, w)
    nw, nh = round(w * size / short), round(h * size / short)
    dev = frames.device
    mh = _coefficients(w, nw, (nw - size) // 2, size).to(dev)
    mv = _coefficients(h, nh, (nh - size) // 2, size).to(dev)
    out = []
    for f in frames:                              # one frame at a time
        x = f.to(torch.float64)                   # (h, w, 3)
        x = _round_clip(torch.einsum("hwc,sw->hsc", x, mh))
        x = _round_clip(torch.einsum("hsc,rh->rsc", x, mv))
        out.append(x.to(torch.uint8))
    return torch.stack(out)


def normalize(px: torch.Tensor, mean, std) -> torch.Tensor:
    x = px.float() / 255.0
    return ((x - torch.tensor(mean, device=px.device))
            / torch.tensor(std, device=px.device))


# ------------------------------------------------------------------- CLIP
class CLIPAttention(nn.Module):
    def __init__(self, d, heads, *, device=None):
        super().__init__()
        self.q = Linear(d, d, device=device)
        self.k = Linear(d, d, device=device)
        self.v = Linear(d, d, device=device)
        self.o = Linear(d, d, device=device)
        self.heads = heads

    def forward(self, x):
        b, n, d = x.shape
        dh = d // self.heads

        def split(t):
            return t.view(b, n, self.heads, dh).transpose(1, 2)

        out = softmax_attention(split(self.q(x)), split(self.k(x)),
                                split(self.v(x)), scale=dh ** -0.5)
        return self.o(out.transpose(1, 2).reshape(b, n, d))


class CLIPMLP(nn.Module):
    def __init__(self, d, hidden, act, *, device=None):
        super().__init__()
        self.fc1 = Linear(d, hidden, device=device)
        self.fc2 = Linear(hidden, d, device=device)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        if self.act == "quick_gelu":
            return self.fc2(h * torch.sigmoid(1.702 * h))
        h = F.gelu(h)
        return self.fc2(h)


class CLIPBlock(nn.Module):
    def __init__(self, c, *, device=None):
        super().__init__()
        d, eps = c["hidden_size"], c["layer_norm_eps"]
        self.ln1 = LayerNorm(d, eps, device=device)
        self.attn = CLIPAttention(d, c["num_heads"], device=device)
        self.ln2 = LayerNorm(d, eps, device=device)
        self.mlp = CLIPMLP(d, c["intermediate_size"], c["hidden_act"],
                           device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class PatchEmbed(nn.Module):
    def __init__(self, d, p, *, device=None):
        super().__init__()
        self.patch = p
        self.weight = nn.Parameter(torch.empty(d, 3, p, p, device=device),
                                   requires_grad=False)

    def forward(self, px):
        out = F.conv2d(fp8(px.permute(0, 3, 1, 2)), fp8(self.weight),
                       stride=self.patch)
        return out.flatten(2).transpose(1, 2)


class CLIPVisionModel(nn.Module):
    """normalised pixels (b, S, S, 3) -> projected class token."""

    def __init__(self, c: dict, *, device=None):
        super().__init__()
        d, eps = c["hidden_size"], c["layer_norm_eps"]
        n = (c["image_size"] // c["patch_size"]) ** 2 + 1
        self.patch_embed = PatchEmbed(d, c["patch_size"], device=device)
        self.class_embedding = nn.Parameter(torch.empty(d, device=device),
                                            requires_grad=False)
        self.position_embedding = nn.Parameter(
            torch.empty(n, d, device=device), requires_grad=False)
        self.pre_layernorm = LayerNorm(d, eps, device=device)
        self.blocks = nn.ModuleList([CLIPBlock(c, device=device)
                                     for _ in range(c["num_layers"])])
        self.post_layernorm = LayerNorm(d, eps, device=device)
        self.visual_projection = Linear(d, c["projection_dim"], bias=False,
                                        device=device)

    def forward(self, px):
        b = px.shape[0]
        x = torch.cat([self.class_embedding.expand(b, 1, -1),
                       self.patch_embed(px)], 1) + self.position_embedding
        x = self.pre_layernorm(x)
        for blk in self.blocks:
            x = blk(x)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


# ----------------------------------------------------------------- DINOv2
class Dinov2Attention(CLIPAttention):
    pass


class Dinov2SwiGLU(nn.Module):
    def __init__(self, d, hidden, *, device=None):
        super().__init__()
        self.weights_in = Linear(d, 2 * hidden, device=device)
        self.weights_out = Linear(hidden, d, device=device)

    def forward(self, x):
        a, b = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(a) * b)


class Dinov2Block(nn.Module):
    def __init__(self, c, *, device=None):
        super().__init__()
        d, eps = c["hidden_size"], c["layer_norm_eps"]
        hidden = (int(int(d * c["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8
        self.norm1 = LayerNorm(d, eps, device=device)
        self.attn = Dinov2Attention(d, c["num_heads"], device=device)
        self.scale1 = nn.Parameter(torch.empty(d, device=device),
                                   requires_grad=False)
        self.norm2 = LayerNorm(d, eps, device=device)
        self.mlp = Dinov2SwiGLU(d, hidden, device=device)
        self.scale2 = nn.Parameter(torch.empty(d, device=device),
                                   requires_grad=False)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.scale1
        return x + self.mlp(self.norm2(x)) * self.scale2


class Dinov2Model(nn.Module):
    """normalised pixels (b, S, S, 3) -> normed class token."""

    def __init__(self, c: dict, *, device=None):
        super().__init__()
        if not c["use_swiglu_ffn"]:
            raise ValueError("the reference DINOv2 has the giant's SwiGLU")
        d, p = c["hidden_size"], c["patch_size"]
        n = (c["image_size"] // p) ** 2 + 1
        self.patch_embed = Conv2d(3, d, p, stride=p, device=device)
        self.cls_token = nn.Parameter(torch.empty(d, device=device),
                                      requires_grad=False)
        self.position_embedding = nn.Parameter(
            torch.empty(n, d, device=device), requires_grad=False)
        self.blocks = nn.ModuleList([Dinov2Block(c, device=device)
                                     for _ in range(c["num_layers"])])
        self.layernorm = LayerNorm(d, c["layer_norm_eps"], device=device)

    def forward(self, px):
        b = px.shape[0]
        patches = self.patch_embed(px.permute(0, 3, 1, 2)).flatten(2)
        x = torch.cat([self.cls_token.expand(b, 1, -1),
                       patches.transpose(1, 2)], 1) + self.position_embedding
        for blk in self.blocks:
            x = blk(x)
        return self.layernorm(x[:, 0])


# --------------------------------------------------------------- ConvNeXt
def _nhwc(conv, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNextBlock(nn.Module):
    def __init__(self, d, eps, *, device=None):
        super().__init__()
        self.dwconv = Conv2d(d, d, 7, padding=3, groups=d, device=device)
        self.norm = LayerNorm(d, eps, device=device)
        self.pwconv1 = Linear(d, 4 * d, device=device)
        self.pwconv2 = Linear(4 * d, d, device=device)
        self.scale = nn.Parameter(torch.empty(d, device=device),
                                  requires_grad=False)

    def forward(self, x):
        h = self.norm(_nhwc(self.dwconv, x))
        return x + self.pwconv2(F.gelu(self.pwconv1(h))) * self.scale


class ConvNextDownsample(nn.Module):
    def __init__(self, cin, cout, eps, *, device=None):
        super().__init__()
        self.norm = LayerNorm(cin, eps, device=device)
        self.conv = Conv2d(cin, cout, 2, stride=2, device=device)

    def forward(self, x):
        return _nhwc(self.conv, self.norm(x))


class ConvNextCLIP(nn.Module):
    """normalised pixels (b, S, S, 3) -> embedding (b, embed_dim)."""

    def __init__(self, c: dict, *, device=None):
        super().__init__()
        dims, eps = c["hidden_sizes"], c["layer_norm_eps"]
        self.stem_conv = Conv2d(3, dims[0], 4, stride=4, device=device)
        self.stem_norm = LayerNorm(dims[0], eps, device=device)
        self.downsamples = nn.ModuleList([
            ConvNextDownsample(dims[i], dims[i + 1], eps, device=device)
            for i in range(3)])
        self.stages = nn.ModuleList([
            nn.ModuleList([ConvNextBlock(dims[s], eps, device=device)
                           for _ in range(c["depths"][s])])
            for s in range(4)])
        self.head_norm = LayerNorm(dims[-1], eps, device=device)
        self.head_fc1 = Linear(dims[-1], 2 * c["embed_dim"], device=device)
        self.head_fc2 = Linear(2 * c["embed_dim"], c["embed_dim"],
                               device=device)

    def forward(self, px):
        x = self.stem_norm(_nhwc(self.stem_conv, px))
        for s, blocks in enumerate(self.stages):
            if s:
                x = self.downsamples[s - 1](x)
            for blk in blocks:
                x = blk(x)
        pooled = self.head_norm(x.mean(dim=(1, 2)))
        return self.head_fc2(F.gelu(self.head_fc1(pooled)))


# tower name -> (model class, config key of its output width, mean, std),
# in the order "mixed" concatenates them
TOWERS = {
    "clip_vit": (CLIPVisionModel, "projection_dim", CLIP_MEAN, CLIP_STD),
    "clip_vit2": (CLIPVisionModel, "projection_dim", CLIP_MEAN, CLIP_STD),
    "clip_convnext": (ConvNextCLIP, "embed_dim", CLIP_MEAN, CLIP_STD),
    "dinov2": (Dinov2Model, "hidden_size", IMAGENET_MEAN, IMAGENET_STD),
}
