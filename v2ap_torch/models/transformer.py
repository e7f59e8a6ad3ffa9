"""Tri-stream DiT-style transformer backbone.

Counterpart of ``v2ap_tpu/models/transformer.py``. Three token streams at
the latent frame rate — audio (the flow state, time-conditioned through
AdaptiveRMSNorm + AdaLN-Zero, with conv, self-attention, cross-attention to
the prompt context and U-Net skips), text (per-frame CLIP embeddings) and
frames (piano roll) — exchange information per layer through zero-init
linear fusions. 32 registers are prepended to every stream; the key-padding
mask is shared (registers always attend). Matmuls run in the config's
compute dtype, norms and softmax in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from v2ap_torch.config import ModelConfig
from v2ap_torch.ops.attention import Attention
from v2ap_torch.ops.conv import DepthwiseConv1d
from v2ap_torch.ops.feedforward import GLUFeedForward
from v2ap_torch.ops.fourier import TimeCondMLP
from v2ap_torch.ops.layers import Embed, Linear
from v2ap_torch.ops.norms import AdaLNZero, AdaptiveRMSNorm, RMSNorm
from v2ap_torch.ops.rope import rope_table


class CrossCondition(nn.Module):
    """audio += W_a([audio,text,frames]); text += W_t([audio,text]) (off on
    the last text layer); frames += W_f([audio,frames]). Zero-initialised."""

    def __init__(self, dim: int, dim_text: int, dim_frames: int,
                 cond_audio_to_others: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(bias=False, zero_init=True, dtype=dtype, device=device)
        self.to_audio = Linear(dim + dim_text + dim_frames, dim, **kw)
        self.cond_audio_to_others = cond_audio_to_others
        if cond_audio_to_others:
            self.to_text = Linear(dim + dim_text, dim_text, **kw)
            self.to_frames = Linear(dim + dim_frames, dim_frames, **kw)

    def forward(self, audio, text, frames):
        audio_out = audio + self.to_audio(torch.cat([audio, text, frames], -1))
        if self.cond_audio_to_others:
            text = text + self.to_text(torch.cat([audio, text], -1))
            frames = frames + self.to_frames(torch.cat([audio, frames], -1))
        return audio_out, text, frames


class StreamBlock(nn.Module):
    """conv? -> attn -> ff tower for the text / frames streams."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int,
                 kernel_size: int, use_conv: bool, cfg: ModelConfig, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = (DepthwiseConv1d(dim, kernel_size, dtype=dtype,
                                     device=device) if use_conv else None)
        self.attn_norm = RMSNorm(dim, device=device)
        self.attn = Attention(dim, heads, dim_head,
                              gate_value_heads=cfg.gate_value_heads,
                              softclamp_logits=cfg.softclamp_logits,
                              softclamp_value=cfg.softclamp_value,
                              dtype=dtype, device=device)
        self.ff_norm = RMSNorm(dim, device=device)
        self.ff = GLUFeedForward(dim, ff_mult, dtype=dtype, device=device)

    def forward(self, x, *, rotary, mask):
        if self.conv is not None:
            x = self.conv(x, mask=mask) + x
        x = self.attn(self.attn_norm(x), rotary=rotary, mask=mask) + x
        return self.ff(self.ff_norm(x)) + x


class AudioBlock(nn.Module):
    """Time-conditioned audio-stream block: skip merge, conv, self-attn,
    cross-attn and FF, each branch gated by AdaLN-Zero."""

    def __init__(self, cfg: ModelConfig, is_later_half: bool, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        dim = cfg.dim
        self.skip_proj = (Linear(dim * 2, dim, bias=False, dtype=dtype,
                                 device=device) if is_later_half else None)
        self.conv = (DepthwiseConv1d(dim, cfg.kernel_size, dtype=dtype,
                                     device=device)
                     if cfg.if_audio_conv else None)
        attn_kw = dict(gate_value_heads=cfg.gate_value_heads,
                       softclamp_logits=cfg.softclamp_logits,
                       softclamp_value=cfg.softclamp_value, dtype=dtype,
                       device=device)
        self.attn_norm = AdaptiveRMSNorm(dim, device=device)
        self.attn = Attention(dim, cfg.heads, cfg.dim_head, **attn_kw)
        self.attn_gate = AdaLNZero(dim, device=device)
        if cfg.if_cross_attn:
            self.cross_norm = AdaptiveRMSNorm(dim, device=device)
            self.cross_attn = Attention(dim, cfg.heads, cfg.dim_head,
                                        dim_context=cfg.dim_context,
                                        cross_attention=True, **attn_kw)
            self.cross_gate = AdaLNZero(dim, device=device)
            # with context=None the cross-attention degrades to rotary
            # self-attention over x, which needs dim-wide context projections
            self.cross_self_ok = cfg.dim_context == dim
        else:
            self.cross_attn = None
            self.cross_self_ok = False
        self.ff_norm = AdaptiveRMSNorm(dim, device=device)
        self.ff = GLUFeedForward(dim, cfg.ff_mult, dtype=dtype, device=device)
        self.ff_gate = AdaLNZero(dim, device=device)

    def cond_projections(self):
        """The block's time-cond projection owners in gamma-slot order."""
        mods = [self.attn_norm, self.attn_gate]
        if self.cross_attn is not None:
            mods += [self.cross_norm, self.cross_gate]
        return mods + [self.ff_norm, self.ff_gate]

    def forward(self, x, skip, *, cond, rotary, mask, context, context_mask,
                gammas=None):
        if self.skip_proj is not None:
            x = self.skip_proj(torch.cat([x, skip], dim=-1))
        if self.conv is not None:
            x = self.conv(x, mask=mask) + x
        # gammas: (b, n_slots, dim) raw cond projections, or None to project
        # inside each norm / gate
        g = (lambda i: gammas[:, i]) if gammas is not None else (lambda i: None)
        attn_out = self.attn(self.attn_norm(x, condition=cond, gamma=g(0)),
                             rotary=rotary, mask=mask)
        x = x + self.attn_gate(attn_out, condition=cond, gamma=g(1))
        slot = 2
        if self.cross_attn is not None and (context is not None
                                            or self.cross_self_ok):
            cross_out = self.cross_attn(
                self.cross_norm(x, condition=cond, gamma=g(2)), rotary=rotary,
                mask=mask, context=context, context_mask=context_mask)
            x = x + self.cross_gate(cross_out, condition=cond, gamma=g(3))
        if self.cross_attn is not None:
            slot = 4
        ff_out = self.ff(self.ff_norm(x, condition=cond, gamma=g(slot)))
        return x + self.ff_gate(ff_out, condition=cond, gamma=g(slot + 1))


class TriStreamTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.depth % 2:
            raise ValueError("depth must be even for U-Net skips")
        if not 1 <= cfg.text_depth <= cfg.depth:
            raise ValueError(f"text_depth {cfg.text_depth} not in [1, depth]")
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        r = cfg.num_registers
        self.registers = nn.Parameter(
            torch.randn(r, cfg.dim, device=device) * 0.02)
        self.text_registers = nn.Parameter(
            torch.randn(r, cfg.dim_text, device=device) * 0.02)
        self.frames_registers = nn.Parameter(
            torch.randn(r, cfg.dim_frames, device=device) * 0.02)
        self.abs_pos_emb = (Embed(cfg.max_seq_len, cfg.dim, dtype=dtype,
                                  device=device) if cfg.abs_pos_emb else None)
        self.time_mlp = TimeCondMLP(cfg.dim, device=device)

        self.audio_blocks = nn.ModuleList()
        self.text_blocks = nn.ModuleList()       # the first text_depth layers
        self.frames_blocks = nn.ModuleList()
        self.cross_conditions = nn.ModuleList()  # the first text_depth layers
        for ind in range(cfg.depth):
            self.audio_blocks.append(AudioBlock(
                cfg, ind >= cfg.depth // 2, dtype=dtype, device=device))
            if ind < cfg.text_depth:
                self.text_blocks.append(StreamBlock(
                    cfg.dim_text, cfg.text_heads, cfg.text_dim_head,
                    cfg.text_ff_mult, cfg.kernel_size, cfg.if_text_conv, cfg,
                    dtype=dtype, device=device))
                self.cross_conditions.append(CrossCondition(
                    cfg.dim, cfg.dim_text, cfg.dim_frames,
                    cond_audio_to_others=ind != cfg.text_depth - 1,
                    dtype=dtype, device=device))
            self.frames_blocks.append(StreamBlock(
                cfg.dim_frames, cfg.frames_heads, cfg.frames_dim_head,
                cfg.frames_ff_mult, cfg.kernel_size, True, cfg,
                dtype=dtype, device=device))
        self.final_norm = RMSNorm(cfg.dim, device=device)

    def _fused_cond_gammas(self, cond: torch.Tensor) -> torch.Tensor:
        """All audio layers' time-cond projections as one stacked matmul.
        Returns (depth, b, slots, dim) float32 raw projections."""
        mods = [blk.cond_projections() for blk in self.audio_blocks]
        slots = len(mods[0])
        dim = self.cfg.dim
        weight = torch.cat([m.to_gamma.weight for layer in mods
                            for m in layer], dim=0)
        bias = torch.cat([
            m.to_gamma.bias if m.to_gamma.bias is not None
            else torch.zeros(dim, device=cond.device)
            for layer in mods for m in layer])
        g = cond.float() @ weight.T + bias          # (b, depth*slots*dim)
        g = g.reshape(cond.shape[0], len(mods), slots, dim)
        return g.permute(1, 0, 2, 3)

    def forward(
        self,
        x: torch.Tensor,                     # (b, n, dim) projected latents
        *,
        times: torch.Tensor,                 # (b,) flow time in [0, 1]
        mask: torch.Tensor | None,           # (b, n) True == valid
        text_embed: torch.Tensor,            # (b, n, dim_text)
        frames_embed: torch.Tensor,          # (b, n, dim_frames)
        context: torch.Tensor | None = None,        # (b, nc, dim_context)
        context_mask: torch.Tensor | None = None,   # (b, nc)
    ) -> torch.Tensor:
        cfg = self.cfg
        b, n, _ = x.shape
        r = cfg.num_registers
        if self.abs_pos_emb is not None:
            if n > cfg.max_seq_len:
                raise ValueError(f"{n} > max_seq_len {cfg.max_seq_len}")
            x = x + self.abs_pos_emb(torch.arange(n, device=x.device))
        cond = self.time_mlp(times)                       # (b, dim)

        def tile(p):
            return p[None].expand(b, r, p.shape[-1]).to(x.dtype)

        x = torch.cat([tile(self.registers), x], dim=1)
        text_embed = torch.cat([tile(self.text_registers),
                                text_embed.to(x.dtype)], dim=1)
        frames_embed = torch.cat([tile(self.frames_registers),
                                  frames_embed.to(x.dtype)], dim=1)
        if mask is not None:
            mask = torch.cat([torch.ones(b, r, dtype=torch.bool,
                                         device=x.device), mask.bool()], dim=1)

        # all three rotary tables are sized from the AUDIO head width; a
        # stream with wider heads gets partial rotary (reference
        # e2_tts_crossatt3.py:777-781), a narrower one its own width
        total = n + r
        rot_audio = rope_table(total, cfg.dim_head, device=x.device)

        def clamp(d):
            return rot_audio if d >= cfg.dim_head else rope_table(
                total, d, device=x.device)

        rot_text = clamp(cfg.text_dim_head)
        rot_frames = clamp(cfg.frames_dim_head)

        skips = []
        all_gammas = self._fused_cond_gammas(cond) if cfg.fused_adaln else None
        for ind in range(cfg.depth):
            layer = ind + 1
            skip = None if layer <= cfg.depth // 2 else skips.pop()
            if ind < cfg.text_depth:
                text_embed = self.text_blocks[ind](text_embed, rotary=rot_text,
                                                   mask=mask)
                frames_embed = self.frames_blocks[ind](
                    frames_embed, rotary=rot_frames, mask=mask)
                x, text_embed, frames_embed = self.cross_conditions[ind](
                    x, text_embed, frames_embed)
            x_mid = x
            x = self.audio_blocks[ind](
                x, skip, cond=cond, rotary=rot_audio, mask=mask,
                context=context, context_mask=context_mask,
                gammas=None if all_gammas is None else all_gammas[ind])
            if layer <= cfg.depth // 2:
                skips.append(x_mid)
        return self.final_norm(x[:, r:])
