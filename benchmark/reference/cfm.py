"""Plain float32 reference of the conditional flow-matching model: the
tri-stream transformer (audio, per-frame video features, piano roll; 32
registers; U-Net skips; zero-initialised fusions between the streams), its
prediction head, and sway-schedule Euler sampling with classifier-free
guidance folded into one batch-doubled evaluation per step.

Written from the model's equations (e2_tts_crossatt3.py); the parameter
names are the served model's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.nn import (AdaLNZero, AdaptiveRMSNorm, Attention,
                                    DepthwiseConv1d, Embed, GLUFeedForward,
                                    Linear, RMSNorm, TimeCondMLP, rope_table)
from benchmark.reference.video2roll import Video2RollNet


class CrossCondition(nn.Module):
    def __init__(self, dim, dim_text, dim_frames, to_others, *, device=None):
        super().__init__()
        self.to_audio = Linear(dim + dim_text + dim_frames, dim, bias=False,
                               device=device)
        self.to_others = to_others
        if to_others:
            self.to_text = Linear(dim + dim_text, dim_text, bias=False,
                                  device=device)
            self.to_frames = Linear(dim + dim_frames, dim_frames, bias=False,
                                    device=device)

    def forward(self, audio, text, frames):
        out = audio + self.to_audio(torch.cat([audio, text, frames], -1))
        if self.to_others:
            text = text + self.to_text(torch.cat([audio, text], -1))
            frames = frames + self.to_frames(torch.cat([audio, frames], -1))
        return out, text, frames


def _attention(m, dim, heads, dim_head, **kw):
    softclamp = m["softclamp_value"] if m["softclamp_logits"] else None
    return Attention(dim, heads, dim_head, softclamp=softclamp,
                     gate_value_heads=m["gate_value_heads"], **kw)


class StreamBlock(nn.Module):
    def __init__(self, m, dim, heads, dim_head, ff_mult, use_conv, *,
                 device=None):
        super().__init__()
        self.conv = (DepthwiseConv1d(dim, m["kernel_size"], device=device)
                     if use_conv else None)
        self.attn_norm = RMSNorm(dim, device=device)
        self.attn = _attention(m, dim, heads, dim_head, device=device)
        self.ff_norm = RMSNorm(dim, device=device)
        self.ff = GLUFeedForward(dim, ff_mult, device=device)

    def forward(self, x, rotary, mask):
        if self.conv is not None:
            x = self.conv(x, mask) + x
        x = self.attn(self.attn_norm(x), rotary=rotary, mask=mask) + x
        return self.ff(self.ff_norm(x)) + x


class AudioBlock(nn.Module):
    def __init__(self, m, later_half, *, device=None):
        super().__init__()
        dim = m["dim"]
        self.skip_proj = (Linear(2 * dim, dim, bias=False, device=device)
                          if later_half else None)
        self.conv = (DepthwiseConv1d(dim, m["kernel_size"], device=device)
                     if m["if_audio_conv"] else None)
        self.attn_norm = AdaptiveRMSNorm(dim, device=device)
        self.attn = _attention(m, dim, m["heads"], m["dim_head"],
                               device=device)
        self.attn_gate = AdaLNZero(dim, device=device)
        self.cross_norm = AdaptiveRMSNorm(dim, device=device)
        self.cross_attn = _attention(m, dim, m["heads"], m["dim_head"],
                                     dim_context=m["dim_context"],
                                     cross_attention=True, device=device)
        self.cross_gate = AdaLNZero(dim, device=device)
        self.ff_norm = AdaptiveRMSNorm(dim, device=device)
        self.ff = GLUFeedForward(dim, m["ff_mult"], device=device)
        self.ff_gate = AdaLNZero(dim, device=device)

    def forward(self, x, skip, cond, rotary, mask, context, context_mask):
        if self.skip_proj is not None:
            x = self.skip_proj(torch.cat([x, skip], -1))
        if self.conv is not None:
            x = self.conv(x, mask) + x
        a = self.attn(self.attn_norm(x, cond), rotary=rotary, mask=mask)
        x = x + self.attn_gate(a, cond)
        c = self.cross_attn(self.cross_norm(x, cond), context=context,
                            context_mask=context_mask)
        x = x + self.cross_gate(c, cond)
        return x + self.ff_gate(self.ff(self.ff_norm(x, cond)), cond)


class TriStreamTransformer(nn.Module):
    def __init__(self, m: dict, *, device=None):
        super().__init__()
        self.m = m
        r = m["num_registers"]
        p = dict(device=device)
        self.registers = nn.Parameter(torch.empty(r, m["dim"], **p),
                                      requires_grad=False)
        self.text_registers = nn.Parameter(
            torch.empty(r, m["dim_text"], **p), requires_grad=False)
        self.frames_registers = nn.Parameter(
            torch.empty(r, m["dim_frames"], **p), requires_grad=False)
        self.abs_pos_emb = Embed(m["max_seq_len"], m["dim"], **p)
        self.time_mlp = TimeCondMLP(m["dim"], **p)
        depth, text_depth = m["depth"], m["text_depth"]
        self.audio_blocks = nn.ModuleList(
            [AudioBlock(m, i >= depth // 2, **p) for i in range(depth)])
        self.text_blocks = nn.ModuleList([
            StreamBlock(m, m["dim_text"], m["text_heads"], m["text_dim_head"],
                        m["text_ff_mult"], m["if_text_conv"], **p)
            for _ in range(text_depth)])
        self.cross_conditions = nn.ModuleList([
            CrossCondition(m["dim"], m["dim_text"], m["dim_frames"],
                           i != text_depth - 1, **p)
            for i in range(text_depth)])
        self.frames_blocks = nn.ModuleList([
            StreamBlock(m, m["dim_frames"], m["frames_heads"],
                        m["frames_dim_head"], m["frames_ff_mult"], True, **p)
            for _ in range(depth)])
        self.final_norm = RMSNorm(m["dim"], **p)

    def forward(self, x, times, mask, text, frames, context, context_mask):
        m = self.m
        b, n, _ = x.shape
        r = m["num_registers"]
        x = x + self.abs_pos_emb(torch.arange(n, device=x.device))
        cond = self.time_mlp(times)

        def tile(p):
            return p[None].expand(b, r, p.shape[-1])

        x = torch.cat([tile(self.registers), x], 1)
        text = torch.cat([tile(self.text_registers), text], 1)
        frames = torch.cat([tile(self.frames_registers), frames], 1)
        mask = torch.cat([torch.ones(b, r, dtype=torch.bool, device=x.device),
                          mask], 1)
        total = n + r
        rot = rope_table(total, m["dim_head"], device=x.device)
        def stream_rope(d):           # sized from the audio head width
            return (rot if d >= m["dim_head"]
                    else rope_table(total, d, device=x.device))

        rot_text = stream_rope(m["text_dim_head"])
        rot_frames = stream_rope(m["frames_dim_head"])
        skips = []
        depth = m["depth"]
        for i in range(depth):
            skip = skips.pop() if i >= depth // 2 else None
            if i < m["text_depth"]:
                text = self.text_blocks[i](text, rot_text, mask)
                frames = self.frames_blocks[i](frames, rot_frames, mask)
                x, text, frames = self.cross_conditions[i](x, text, frames)
            if i < depth // 2:
                skips.append(x)
            x = self.audio_blocks[i](x, skip, cond, rot, mask, context,
                                     context_mask)
        return self.final_norm(x[:, r:])


def sway_timesteps(steps: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, steps, dtype=np.float64)
    t = t - (np.cos(np.pi / 2.0 * t) - 1.0 + t)
    return t.astype(np.float32)


class CFM(nn.Module):
    def __init__(self, m: dict, cond: dict, *, device=None):
        super().__init__()
        self.m, self.cond = m, cond
        self.transformer = TriStreamTransformer(m, device=device)
        c = m["num_channels"]
        self.proj_in = Linear(c, m["dim"], device=device)
        if m["if_cond_proj_in"]:      # unused by sampling; kept for the names
            self.cond_proj_in = Linear(c, m["dim"],
                                       bias=m["cond_proj_in_bias"],
                                       device=device)
        self.to_pred = Linear(m["dim"], c, device=device)
        self.proj_frames = Linear(m["notes"], m["dim_frames"], device=device)
        self.proj_text = (Linear(m["dim_text_raw"], m["dim_text"],
                                 device=device)
                          if m["dim_text_raw"] else None)
        self.video2roll = (Video2RollNet(m["notes"], device=device)
                           if m["video2roll"] else None)

    def pred_head(self, x, times, mask, text, frames, context, context_mask):
        h = self.proj_in(x)
        if self.proj_text is not None:
            text = self.proj_text(text)
        out = self.transformer(h, times, mask, text, self.proj_frames(frames),
                               context, context_mask)
        return self.to_pred(out)

    def encode_frames(self, frames, length: int, chunk: int = 64):
        """Keyboard strips (1, t, H, W) in [0, 1] -> roll probabilities
        (1, length, notes): edge-clamped windows of ``piano_window`` strips
        through Video2Roll (``chunk`` windows at a time), sigmoid, repeated
        ``video_multi`` times to the latent rate, trimmed or zero-padded."""
        _, t, hh, ww = frames.shape
        w = self.cond["piano_window"]
        half = w // 2
        idx = (torch.arange(t, device=frames.device)[:, None]
               + torch.arange(-half, w - half, device=frames.device)[None, :]
               ).clamp(0, t - 1)
        logits = torch.cat([self.video2roll(frames[0, idx[i: i + chunk]])
                            for i in range(0, t, chunk)])
        probs = torch.sigmoid(logits)[None]
        notes = self.m["notes"]
        vm = 3.0 if notes == 51 else 2.5
        if float(vm).is_integer():
            probs = probs.repeat_interleave(int(vm), dim=1)
        else:
            rep = probs.repeat_interleave(5, dim=1)
            t5 = (rep.shape[1] // 2) * 2
            probs = rep[:, :t5].reshape(1, t5 // 2, 2, notes).mean(dim=2)
        cur = probs.shape[1]
        if cur >= length:
            return probs[:, :length]
        return torch.nn.functional.pad(probs, (0, 0, 0, length - cur))

    def sample(self, x0, text, frames, context, context_mask, mask,
               steps: int, cfg_strength: float):
        """Euler integration over the sway grid; each step evaluates the
        conditioned and the null branch (video features and prompt zeroed,
        roll kept) in one doubled batch."""
        b = x0.shape[0]
        text2 = torch.cat([text, torch.zeros_like(text)])
        frames2 = torch.cat([frames, frames])
        ctx2 = torch.cat([context, torch.zeros_like(context)])
        ctxm2 = torch.cat([context_mask, context_mask])
        mask2 = torch.cat([mask, mask])
        ts = sway_timesteps(steps)
        y = x0
        for t, dt in zip(ts[:-1], ts[1:] - ts[:-1]):
            times = torch.full((2 * b,), float(t), device=x0.device)
            pred = self.pred_head(torch.cat([y, y]), times, mask2, text2,
                                  frames2, ctx2, ctxm2)
            cond_pred, null_pred = pred[:b], pred[b:]
            y = y + float(dt) * (cond_pred
                                 + (cond_pred - null_pred) * cfg_strength)
        return y
