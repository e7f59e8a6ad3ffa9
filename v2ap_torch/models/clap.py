"""CLAP (contrastive language-audio pretraining): the HTSAT Swin audio
tower, the RoBERTa text tower and their projection heads.

Counterpart of ``v2ap_tpu/models/clap.py``, laid out after Hugging Face's
``ClapModel`` so that the published ``laion/clap-htsat-unfused`` state dict
reads in directly (``load_clap_state_dict``, no ``transformers`` needed).

Audio path: log-mel (b, 1, T, mels) -> BatchNorm over the mel bins ->
``reshape_mel2img`` (T resized to spec_size * freq_ratio by JAX's bicubic
resize, folded into a spec_size x spec_size image) -> 4x4 patch embed ->
Swin stages (windowed attention with a relative-position bias, shifted
windows on odd blocks with a -100 mask, patch merging) -> LayerNorm ->
token mean -> 2-layer projection (ReLU).

Text path: RoBERTa (positions counted over the non-pad ids, offset past the
pad id 1; post-LN blocks with a -1e9 key mask) -> tanh pooler on the first
token -> projection.

The JAX package computes both attentions with einsum outside any Pallas
kernel, so here they are plain PyTorch products in float32. Grids are
NHWC inside the Swin stages, as in JAX; the patch embedding is an NCHW
``F.conv2d``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import BatchNorm2d, Conv2d, Embed, LayerNorm, Linear
from v2ap_torch.ops.melspec import apply_filterbank, frame_power, mel_filterbank


@dataclasses.dataclass(frozen=True)
class ClapAudioConfig:
    spec_size: int = 256
    num_mel_bins: int = 64
    patch_size: int = 4
    patch_stride: int = 4
    patch_embeds_hidden_size: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512
    projection_hidden_size: int = 768
    dtype: str = "float32"

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def num_features(self) -> int:
        return self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1)


@dataclasses.dataclass(frozen=True)
class ClapTextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12
    projection_dim: int = 512
    dtype: str = "float32"


def clap_htsat_unfused() -> Tuple[ClapAudioConfig, ClapTextConfig]:
    """laion/clap-htsat-unfused, the standard audio-text scorer."""
    return ClapAudioConfig(), ClapTextConfig()


def clap_tiny_test() -> Tuple[ClapAudioConfig, ClapTextConfig]:
    audio = ClapAudioConfig(
        spec_size=32, num_mel_bins=8, patch_embeds_hidden_size=16,
        depths=(1, 1), num_heads=(2, 4), window_size=4, projection_dim=24,
        projection_hidden_size=32)
    text = ClapTextConfig(vocab_size=100, hidden_size=32, num_layers=2,
                          num_heads=4, intermediate_size=64,
                          max_position_embeddings=64, projection_dim=24)
    return audio, text


class ClapProjection(nn.Module):
    """linear -> ReLU -> linear (HF ClapProjectionLayer)."""

    def __init__(self, din: int, dout: int, *, dtype, device=None):
        super().__init__()
        self.linear1 = Linear(din, dout, dtype=dtype, device=device)
        self.linear2 = Linear(dout, dout, dtype=dtype, device=device)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


# ----------------------------------------------------------------- audio side

def relative_position_index(window: int) -> np.ndarray:
    """(window^2, window^2) index into the (2w-1)^2 bias table (Swin)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x, w: int):
    """(b, H, W, c) -> (b * H/w * W/w, w*w, c); numpy arrays or tensors."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    perm = (0, 1, 3, 2, 4, 5)
    x = x.transpose(perm) if isinstance(x, np.ndarray) else x.permute(perm)
    return x.reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    b = x.shape[0] // (h // w * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, w*w, w*w) additive mask for shifted windows (-100 off)."""
    img = np.zeros((1, h, w, 1), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = count
            count += 1
    mw = window_partition(img, window)[..., 0]
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "bicubic")``
    along one axis: Keys' cubic with a = -0.5 at half-pixel centres,
    widened by the scale when shrinking (antialias), each output's weights
    renormalised to sum to one, zero for a sample outside the input. The
    identity when the sizes agree (JAX skips that axis)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    inv_scale = np.float32(n_in / n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = (np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                 ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


class SwinAttention(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, dim: int, heads: int, *,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.q = Linear(dim, dim, bias=cfg.qkv_bias, **kw)
        self.k = Linear(dim, dim, bias=cfg.qkv_bias, **kw)
        self.v = Linear(dim, dim, bias=cfg.qkv_bias, **kw)
        self.o = Linear(dim, dim, **kw)
        w = cfg.window_size
        self.heads = heads
        self.dh = dim // heads
        self.bias_table = nn.Parameter(
            torch.zeros((2 * w - 1) ** 2, heads, device=device))
        # a fixed table: rebuilt here, never loaded (convert checks it)
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(w)).to(device), persistent=False)

    def forward(self, x, attn_mask=None):
        # x: (nW*b, n, dim); attn_mask: (nW, n, n) or None
        bw, n, d = x.shape

        def split(t):
            return t.reshape(bw, n, self.heads, self.dh).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        s = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(self.dh)
        bias = self.bias_table[self.rel_index.reshape(-1)]
        s = s + bias.reshape(n, n, -1).permute(2, 0, 1)[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            s = s.reshape(bw // nw, nw, self.heads, n, n)
            s = s + attn_mask[None, :, None]
            s = s.reshape(bw, self.heads, n, n)
        p = torch.softmax(s, dim=-1)
        out = p @ v.float()
        out = out.to(x.dtype).transpose(1, 2).reshape(bw, n, d)
        return self.o(out)


class SwinBlock(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, dim: int, heads: int,
                 resolution: int, shift: int, *, dtype, device=None):
        super().__init__()
        # the window shrinks to the resolution when it no longer fits; the
        # shift is then dropped (HF set_shift_and_window_size)
        self.window = min(cfg.window_size, resolution)
        self.shift = shift if self.window < resolution else 0
        self.resolution = resolution
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm(dim, eps, device=device)
        self.attn = SwinAttention(cfg, dim, heads, dtype=dtype, device=device)
        self.ln2 = LayerNorm(dim, eps, device=device)
        hidden = int(cfg.mlp_ratio * dim)
        self.fc1 = Linear(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Linear(hidden, dim, dtype=dtype, device=device)
        mask = (torch.from_numpy(shift_attn_mask(
            resolution, resolution, self.window, self.shift)).to(device)
            if self.shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x):
        b, n, c = x.shape
        r, s = self.resolution, self.shift
        shortcut = x
        h = self.ln1(x).to(x.dtype).reshape(b, r, r, c)
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
        win = self.attn(window_partition(h, self.window), self.attn_mask)
        h = window_reverse(win.reshape(-1, self.window, self.window, c),
                           self.window, r, r)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = shortcut + h.reshape(b, n, c)
        h = self.ln2(x).to(x.dtype)
        return x + self.fc2(F.gelu(self.fc1(h)))


class PatchMerging(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, dim: int, *, dtype,
                 device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, cfg.layer_norm_eps, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype,
                                device=device)

    def forward(self, x, resolution: int):
        b, n, c = x.shape
        r = resolution
        x = x.reshape(b, r, r, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (r // 2) * (r // 2), 4 * c)
        return self.reduction(self.norm(x))


class ClapAudioModel(nn.Module):
    """log-mel input_features (b, 1, T, mels) -> pooled features
    (b, num_features), HF ``ClapAudioModel().pooler_output``."""

    def __init__(self, cfg: ClapAudioConfig | None = None, *, device=None):
        super().__init__()
        self.cfg = cfg = cfg or ClapAudioConfig()
        self.dtype = dtype = getattr(torch, cfg.dtype)
        self.batch_norm = BatchNorm2d(cfg.num_mel_bins, device=device)
        self.patch_embed = Conv2d(1, cfg.patch_embeds_hidden_size,
                                  cfg.patch_size, stride=cfg.patch_stride,
                                  dtype=dtype, device=device)
        self.patch_norm = LayerNorm(cfg.patch_embeds_hidden_size,
                                    cfg.layer_norm_eps, device=device)
        self.grid = grid = cfg.spec_size // cfg.patch_stride
        stages, mergers = [], []
        for s, depth in enumerate(cfg.depths):
            dim = cfg.patch_embeds_hidden_size * 2 ** s
            res = grid // 2 ** s
            stages.append(nn.ModuleList([
                SwinBlock(cfg, dim, cfg.num_heads[s], res,
                          0 if i % 2 == 0 else cfg.window_size // 2,
                          dtype=dtype, device=device)
                for i in range(depth)]))
            if s < len(cfg.depths) - 1:
                mergers.append(PatchMerging(cfg, dim, dtype=dtype,
                                            device=device))
        self.stages = nn.ModuleList(stages)
        self.mergers = nn.ModuleList(mergers)
        self.norm = LayerNorm(cfg.num_features, cfg.layer_norm_eps,
                              device=device)

    def reshape_mel2img(self, feats: torch.Tensor) -> torch.Tensor:
        """(b, 1, T, mels) -> (b, 1, spec, spec) NCHW, HF's freq-ratio
        folding. Shorter clips are resized up to the expected time width
        with JAX's bicubic resize (``bicubic_matrix``), as a product."""
        cfg = self.cfg
        b, c, t, f = feats.shape
        spec_w = cfg.spec_size * cfg.freq_ratio
        spec_h = cfg.spec_size // cfg.freq_ratio
        assert t <= spec_w and f <= spec_h, (t, f, spec_w, spec_h)
        if t < spec_w or f < spec_h:
            wt = torch.from_numpy(bicubic_matrix(t, spec_w)).to(feats.device)
            wf = torch.from_numpy(bicubic_matrix(f, spec_h)).to(feats.device)
            feats = torch.einsum("bctf,tT,fF->bcTF", feats.float(), wt, wf)
            t, f = spec_w, spec_h
        x = feats.reshape(b, c * cfg.freq_ratio, t // cfg.freq_ratio, f)
        x = x.transpose(2, 3)
        return x.reshape(b, c, f * cfg.freq_ratio, t // cfg.freq_ratio)

    def forward(self, input_features: torch.Tensor) -> torch.Tensor:
        # BN over the mel bins: mels into the channel axis and back
        x = self.batch_norm(input_features.float().transpose(1, 3))
        img = self.reshape_mel2img(x.transpose(1, 3))
        h = self.patch_embed(img.to(self.dtype))       # (b, C, H', W')
        b = h.shape[0]
        h = h.permute(0, 2, 3, 1).reshape(b, -1, self.cfg.patch_embeds_hidden_size)
        h = self.patch_norm(h).to(self.dtype)
        for s, blocks in enumerate(self.stages):
            for blk in blocks:
                h = blk(h)
            if s < len(self.stages) - 1:
                h = self.mergers[s](h, self.grid // 2 ** s)
        h = self.norm(h)
        # HF's freq-bin regroup + AdaptiveAvgPool1d(1) is the token mean
        return h.mean(dim=1).float()


# ------------------------------------------------------------------ text side

class RobertaLayer(nn.Module):
    def __init__(self, cfg: ClapTextConfig, *, dtype, device=None):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        eps = cfg.layer_norm_eps
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, **kw)
        self.v = Linear(d, d, **kw)
        self.attn_out = Linear(d, d, **kw)
        self.attn_ln = LayerNorm(d, eps, device=device)
        self.inter = Linear(d, cfg.intermediate_size, **kw)
        self.out = Linear(cfg.intermediate_size, d, **kw)
        self.out_ln = LayerNorm(d, eps, device=device)
        self.heads = cfg.num_heads
        self.dh = d // cfg.num_heads

    def forward(self, x, mask):
        b, n, d = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, self.dh).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        s = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(self.dh)
        s = torch.where(mask[:, None, None, :], s, -1e9)
        p = torch.softmax(s, dim=-1)
        ctx = (p @ v.float()).to(x.dtype).transpose(1, 2).reshape(b, n, d)
        x = self.attn_ln(self.attn_out(ctx) + x).to(x.dtype)   # post-LN
        h = self.out(F.gelu(self.inter(x)))
        return self.out_ln(h + x).to(x.dtype)


class ClapTextModel(nn.Module):
    """RoBERTa encoder + first-token pooler (dense + tanh), HF
    ``ClapTextModel().pooler_output``."""

    def __init__(self, cfg: ClapTextConfig | None = None, *, device=None):
        super().__init__()
        self.cfg = cfg = cfg or ClapTextConfig()
        self.dtype = dtype = getattr(torch, cfg.dtype)
        self.word_emb = Embed(cfg.vocab_size, cfg.hidden_size, device=device)
        self.pos_emb = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                             device=device)
        self.type_emb = Embed(cfg.type_vocab_size, cfg.hidden_size,
                              device=device)
        self.emb_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                device=device)
        self.layers = nn.ModuleList([RobertaLayer(cfg, dtype=dtype,
                                                  device=device)
                                     for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, dtype=dtype,
                             device=device)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        pad = self.cfg.pad_token_id
        # RoBERTa positions: counted over the non-pad ids (not the attention
        # mask), offset past the pad id
        m = (ids != pad).long()
        pos = torch.cumsum(m, dim=1) * m + pad
        x = (self.word_emb(ids) + self.pos_emb(pos)
             + self.type_emb(torch.zeros_like(ids)))
        x = self.emb_ln(x).to(self.dtype)
        bmask = mask.bool()
        for layer in self.layers:
            x = layer(x, bmask)
        return torch.tanh(self.pooler(x[:, 0])).float()


# -------------------------------------------------------------------- scorer

class ClapModel(nn.Module):
    """Audio-text similarity (HF ``ClapModel``'s surface)."""

    def __init__(self, audio_cfg: ClapAudioConfig | None = None,
                 text_cfg: ClapTextConfig | None = None, *, device=None):
        super().__init__()
        audio_cfg = audio_cfg or ClapAudioConfig()
        text_cfg = text_cfg or ClapTextConfig()
        dtype = getattr(torch, audio_cfg.dtype)
        self.audio_model = ClapAudioModel(audio_cfg, device=device)
        self.text_model = ClapTextModel(text_cfg, device=device)
        self.audio_projection = ClapProjection(
            audio_cfg.num_features, audio_cfg.projection_dim, dtype=dtype,
            device=device)
        self.text_projection = ClapProjection(
            text_cfg.hidden_size, text_cfg.projection_dim, dtype=dtype,
            device=device)

    def get_audio_features(self, input_features: torch.Tensor) -> torch.Tensor:
        emb = self.audio_projection(self.audio_model(input_features))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def get_text_features(self, ids: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        emb = self.text_projection(self.text_model(ids, mask))
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def similarity(self, input_features, ids, mask) -> torch.Tensor:
        """Cosine similarity (b,) of paired audio and text."""
        a = self.get_audio_features(input_features)
        t = self.get_text_features(ids, mask)
        return (a * t).sum(dim=-1)


# ----------------------------------------------------------------- frontend

def clap_logmel(waveform, sr: int = 48_000, n_fft: int = 1024,
                hop: int = 480, n_mels: int = 64, fmin: float = 50.0,
                fmax: float = 14_000.0, slaney: bool = True) -> torch.Tensor:
    """(b, t) at 48 kHz -> (b, 1, frames, n_mels) float32 log-mel dB (HF
    ClapFeatureExtractor's "rand_trunc" path, Slaney filters; the "fusion"
    path takes HTK: ``slaney=False``). A numpy input is computed on the
    CPU, a tensor on its own device."""
    wav = (waveform if isinstance(waveform, torch.Tensor)
           else torch.from_numpy(np.atleast_2d(np.asarray(waveform,
                                                          np.float32))))
    power = frame_power(torch.atleast_2d(wav), n_fft, hop, power=2.0)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, slaney_norm=slaney,
                        slaney_scale=slaney)
    mel = apply_filterbank(power, fb)
    return (10.0 * torch.log10(torch.clamp(mel, min=1e-10)))[:, None]


# ------------------------------------------------------------ weights reader

def load_clap_state_dict(sd: dict, model: ClapModel) -> None:
    """A Hugging Face ``ClapModel`` state dict (``laion/clap-htsat-unfused``:
    ``audio_model.audio_encoder.*``, ``text_model.*``,
    ``{audio,text}_projection.linear{1,2}.*``) -> ``model`` in place,
    without ``transformers``. Counterpart of the JAX package's
    ``load_clap_from_torch``: the same keys, already in PyTorch's layout. A
    needed key that is missing or of another shape raises; a Swin block's
    ``relative_position_index``, where present, must equal the port's
    table. Keys the model has no use for (``logit_scale_*``, position and
    token-type id buffers, ``num_batches_tracked``) are not read."""
    from v2ap_torch.utils.convert import copy_state

    def put(dst: torch.Tensor, key: str) -> None:
        copy_state(dst, sd, key)

    def lin(mod: Linear, key: str) -> None:
        put(mod.weight, f"{key}.weight")
        if mod.bias is not None:
            put(mod.bias, f"{key}.bias")

    def ln(mod: LayerNorm, key: str) -> None:
        put(mod.weight, f"{key}.weight")
        put(mod.bias, f"{key}.bias")

    a = "audio_model.audio_encoder"
    au = model.audio_model
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        put(getattr(au.batch_norm, leaf), f"{a}.batch_norm.{leaf}")
    put(au.patch_embed.weight, f"{a}.patch_embed.proj.weight")
    put(au.patch_embed.bias, f"{a}.patch_embed.proj.bias")
    ln(au.patch_norm, f"{a}.patch_embed.norm")
    for s, blocks in enumerate(au.stages):
        for i, blk in enumerate(blocks):
            p = f"{a}.layers.{s}.blocks.{i}"
            ln(blk.ln1, f"{p}.layernorm_before")
            ln(blk.ln2, f"{p}.layernorm_after")
            for src, dst in (("query", blk.attn.q), ("key", blk.attn.k),
                             ("value", blk.attn.v)):
                lin(dst, f"{p}.attention.self.{src}")
            put(blk.attn.bias_table,
                f"{p}.attention.self.relative_position_bias_table")
            idx_key = f"{p}.attention.self.relative_position_index"
            if idx_key in sd and not np.array_equal(
                    np.asarray(sd[idx_key]), blk.attn.rel_index.cpu()):
                raise ValueError(f"{idx_key} differs from the port's "
                                 f"relative position table")
            lin(blk.attn.o, f"{p}.attention.output.dense")
            lin(blk.fc1, f"{p}.intermediate.dense")
            lin(blk.fc2, f"{p}.output.dense")
        if s < len(au.stages) - 1:
            d = f"{a}.layers.{s}.downsample"
            ln(au.mergers[s].norm, f"{d}.norm")
            lin(au.mergers[s].reduction, f"{d}.reduction")
    ln(au.norm, f"{a}.norm")

    t = "text_model"
    tm = model.text_model
    put(tm.word_emb.weight, f"{t}.embeddings.word_embeddings.weight")
    put(tm.pos_emb.weight, f"{t}.embeddings.position_embeddings.weight")
    put(tm.type_emb.weight, f"{t}.embeddings.token_type_embeddings.weight")
    ln(tm.emb_ln, f"{t}.embeddings.LayerNorm")
    for i, layer in enumerate(tm.layers):
        p = f"{t}.encoder.layer.{i}"
        for src, dst in (("query", layer.q), ("key", layer.k),
                         ("value", layer.v)):
            lin(dst, f"{p}.attention.self.{src}")
        lin(layer.attn_out, f"{p}.attention.output.dense")
        ln(layer.attn_ln, f"{p}.attention.output.LayerNorm")
        lin(layer.inter, f"{p}.intermediate.dense")
        lin(layer.out, f"{p}.output.dense")
        ln(layer.out_ln, f"{p}.output.LayerNorm")
    lin(tm.pooler, f"{t}.pooler.dense")

    for name in ("audio_projection", "text_projection"):
        proj = getattr(model, name)
        lin(proj.linear1, f"{name}.linear1")
        lin(proj.linear2, f"{name}.linear2")
