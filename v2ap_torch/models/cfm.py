"""Conditional flow-matching model over EnCodec latents — the sampling side.

Counterpart of ``pred_head``, ``sample`` and ``_make_cfg_fn`` of
``v2ap_tpu/models/cfm.py``:

  latents (b, n, 128)  --proj_in-->  audio stream
  CLIP frame embeds (b, n, 1280)     text stream (zeroed in the CFG null branch)
  piano-roll probs (b, n, notes) --proj_frames--> frames stream
  prompt states (b, nc, 1024)        cross-attention context
  times (b,)                         AdaLN conditioning

Inference is Euler integration over a sway schedule with classifier-free
guidance folded into one batch-doubled forward per step. This port builds
no Video2Roll net (V2A feeds a zero roll); the training loss,
``encode_frames`` and ``sample_multipass`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2ap_torch.config import ConditioningConfig, ModelConfig, SamplerConfig
from v2ap_torch.models.transformer import TriStreamTransformer
from v2ap_torch.ops.layers import Linear
from v2ap_torch.ops.sampling import (
    euler_integrate, project_parallel, sway_timesteps,
)
from v2ap_torch.utils.device import resolve_device


class CFM(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 cond_cfg: ConditioningConfig | None = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.cond_cfg = cond_cfg or ConditioningConfig()
        dtype = getattr(torch, cfg.dtype)
        self.transformer = TriStreamTransformer(cfg, device=device)
        kw = dict(dtype=dtype, device=device)
        if cfg.concat_cond:
            self.proj_in = Linear(cfg.num_channels * 2, cfg.dim, **kw)
            self.cond_proj_in = None
        else:
            self.proj_in = Linear(cfg.num_channels, cfg.dim, **kw)
            self.cond_proj_in = (
                Linear(cfg.num_channels, cfg.dim, bias=cfg.cond_proj_in_bias,
                       **kw) if cfg.if_cond_proj_in else None)
        self.to_pred = Linear(cfg.dim, cfg.num_channels, **kw)
        self.proj_frames = Linear(cfg.notes, cfg.dim_frames, **kw)
        self.proj_text = (Linear(cfg.dim_text_raw, cfg.dim_text, **kw)
                          if cfg.dim_text_raw else None)

    def pred_head(
        self,
        x: torch.Tensor,                        # (b, n, C) noisy latents
        cond: Optional[torch.Tensor],           # (b, n, C) infill cond or None
        *,
        times: torch.Tensor,                    # (b,)
        mask: Optional[torch.Tensor],           # (b, n)
        text_embed: torch.Tensor,               # (b, n, dim_text)
        frames_embed: torch.Tensor,             # (b, n, notes) roll probs
        context: Optional[torch.Tensor],        # (b, nc, dim_context)
        context_mask: Optional[torch.Tensor],   # (b, nc)
    ) -> torch.Tensor:
        """One transformer evaluation -> predicted flow (b, n, C), float32."""
        if cond is not None and self.cfg.concat_cond:
            h = self.proj_in(torch.cat([cond, x], dim=-1))
        else:
            h = self.proj_in(x)
            if cond is not None and self.cond_proj_in is not None:
                h = h + self.cond_proj_in(cond)
        if self.proj_text is not None and \
                text_embed.shape[-1] != self.cfg.dim_text:
            text_embed = self.proj_text(text_embed)
        out = self.transformer(
            h, times=times, mask=mask, text_embed=text_embed,
            frames_embed=self.proj_frames(frames_embed), context=context,
            context_mask=context_mask)
        return self.to_pred(out).float()

    def sample(
        self,
        x0: torch.Tensor,                       # (b, n, C) gaussian noise
        *,
        text_embed: torch.Tensor,
        frames_embed: torch.Tensor,
        context: Optional[torch.Tensor],
        context_mask: Optional[torch.Tensor],
        mask: Optional[torch.Tensor],
        sampler: SamplerConfig,
        cond: Optional[torch.Tensor] = None,
        cond_mask: Optional[torch.Tensor] = None,
        drop_prompt: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Integrate the flow ODE from noise to data latents. CFG folds the
        full and null branches into one batch-doubled forward per step; the
        null branch drops the audio cond, the CLIP stream and the prompt but
        keeps the piano-roll stream."""
        fn = self._make_cfg_fn(
            batch=x0.shape[0], text_embed=text_embed,
            frames_embed=frames_embed, context=context,
            context_mask=context_mask, mask=mask, sampler=sampler,
            cond=cond, cond_mask=cond_mask, drop_prompt=drop_prompt)
        ts = sway_timesteps(sampler.steps, sampler.sway_sampling)
        out = euler_integrate(fn, x0.float(), ts, method=sampler.method)
        if cond is not None and cond_mask is not None:
            out = torch.where(cond_mask[..., None], cond, out)
        return out

    def _make_cfg_fn(self, *, batch, text_embed, frames_embed, context,
                     context_mask, mask, sampler: SamplerConfig,
                     cond=None, cond_mask=None, drop_prompt=None):
        """Velocity field with CFG folded into one batch-doubled forward."""
        b = batch
        if drop_prompt is not None and context is not None:
            context = context.masked_fill(drop_prompt[:, None, None], 0.0)
        use_cfg = sampler.cfg_strength >= 1e-5
        if use_cfg:
            text2 = torch.cat([text_embed, torch.zeros_like(text_embed)], 0)
            frames2 = torch.cat([frames_embed, frames_embed], 0)
            ctx2 = (torch.cat([context, torch.zeros_like(context)], 0)
                    if context is not None else None)
            ctxm2 = (torch.cat([context_mask, context_mask], 0)
                     if context_mask is not None else None)
            mask2 = torch.cat([mask, mask], 0) if mask is not None else None
        else:
            text2, frames2, ctx2, ctxm2, mask2 = (
                text_embed, frames_embed, context, context_mask, mask)
        step_cond = (torch.where(cond_mask[..., None], cond, 0.0)
                     if cond is not None and cond_mask is not None else None)

        def fn(t: float, x: torch.Tensor) -> torch.Tensor:
            if not use_cfg:
                times = torch.full((b,), t, dtype=torch.float32,
                                   device=x.device)
                return self.pred_head(
                    x, step_cond, times=times, mask=mask2, text_embed=text2,
                    frames_embed=frames2, context=ctx2, context_mask=ctxm2)
            xb = torch.cat([x, x], 0)
            condb = (torch.cat([step_cond, torch.zeros_like(step_cond)], 0)
                     if step_cond is not None else None)
            times = torch.full((2 * b,), t, dtype=torch.float32,
                               device=x.device)
            predb = self.pred_head(
                xb, condb, times=times, mask=mask2, text_embed=text2,
                frames_embed=frames2, context=ctx2, context_mask=ctxm2)
            pred, null_pred = predb[:b], predb[b:]
            update = pred - null_pred
            if sampler.remove_parallel_component:
                parallel, orthogonal = project_parallel(update, pred)
                update = orthogonal + parallel * sampler.keep_parallel_frac
            return pred + update * sampler.cfg_strength

        return fn
