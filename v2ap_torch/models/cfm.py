"""Conditional flow-matching model over EnCodec latents: sampling and the
training loss (V2A, and V2P with the MIDI loss on the Video2Roll stream).

Counterpart of ``pred_head``, ``sample``, ``sample_multipass``,
``_make_cfg_fn`` and ``loss`` of ``v2ap_tpu/models/cfm.py``:

  latents (b, n, 128)  --proj_in-->  audio stream
  CLIP frame embeds (b, n, 1280)     text stream (zeroed in the CFG null branch)
  piano-roll probs (b, n, notes) --proj_frames--> frames stream
  prompt states (b, nc, 1024)        cross-attention context
  times (b,)                         AdaLN conditioning

Inference is Euler integration over a sway schedule with classifier-free
guidance folded into one batch-doubled forward per step. Training is the
span-masked flow-matching MSE with per-sample condition dropout, plus, when
keyboard frames are given, the weighted MSE of Video2Roll's roll against
the ground-truth roll (the MIDI loss, x ``midi_loss_weight``) and its
precision / recall / F1 / accuracy; its seven random draws come from one
helper, ``draw_loss_randoms``, so that a caller can hand in values drawn
elsewhere. ``with_video2roll=True`` builds the Video2Roll net that
``encode_frames`` runs (V2P; V2A feeds a zero roll). It defaults to False
here, unlike JAX's True: the pipelines pass ``ModelConfig.video2roll``, as
JAX's do, and a bare CFM for V2A builds no unused net. Under autograd with
``ModelConfig.remat`` on, ``encode_frames`` runs Video2Roll over
``V2R_REMAT_CHUNK`` windows at a time, each chunk recomputed in the
backward: at a training batch of 8 x 251 windows of 5 x 100 x 900 its
saved activations would otherwise take ~120 GiB. ``sample_multipass`` takes its
restart noise as a tensor (or draws it from a generator before the first
step), so a whole multi-pass trajectory can be captured as one CUDA graph.
``text_num_embeds`` builds the token path's ``embed_text`` (a
``CharacterEmbed``, or with ``interpolated_text`` an
``InterpolatedCharacterEmbed``), which ``embed_tokens`` runs.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.config import ConditioningConfig, ModelConfig, SamplerConfig
from v2ap_torch.models.transformer import TriStreamTransformer, remat
from v2ap_torch.models.video2roll import Video2RollNet
from v2ap_torch.ops.layers import Dropout, Linear
from v2ap_torch.ops.sampling import (
    euler_integrate, lens_to_mask, mask_from_frac_lengths, project_parallel,
    sway_timesteps,
)
from v2ap_torch.utils.device import resolve_device

# Video2Roll windows per recomputed chunk in training under remat: ~65 MB of
# saved activations a window in bf16 (counted by
# tests/test_torch_training_v2p.py), ~8 GiB a chunk
V2R_REMAT_CHUNK = 128


class LossBreakdown(NamedTuple):
    flow: torch.Tensor
    midi: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor
    f1: torch.Tensor
    accuracy: torch.Tensor
    dpo: Any = 0.0
    contrastive: Any = 0.0


class CFMOutput(NamedTuple):
    loss: torch.Tensor
    pred_flow: torch.Tensor
    pred_data: torch.Tensor
    breakdown: LossBreakdown
    # per-sample span-masked flow loss (b,): the DPO scores
    per_sample_flow: Optional[torch.Tensor] = None
    # (audio, CLIP-stream) hiddens at ``collect_hidden_layer``: FactorCL's
    hiddens: Optional[tuple] = None


class LossDraws(NamedTuple):
    """The loss's random draws, in the JAX package's key order: span
    fraction in [lo, hi), span start, x0, t, and the uniforms that the
    audio / text / prompt dropout probabilities are compared with."""
    frac: torch.Tensor          # (b,)
    start: torch.Tensor         # (b,)
    x0: torch.Tensor            # (b, n, c)
    t: torch.Tensor             # (b,)
    drop_audio: torch.Tensor    # (b,)
    drop_text: torch.Tensor     # ()
    drop_prompt: torch.Tensor   # (b,)


def draw_loss_randoms(b: int, n: int, c: int,
                      frac_lengths: tuple[float, float], *,
                      generator: torch.Generator | None = None,
                      device=None) -> LossDraws:
    """Draw the loss's seven random values from ``generator`` on its own
    device (the default CPU generator when None), then move them to
    ``device``."""
    gen_dev = generator.device if generator is not None else "cpu"
    lo, hi = frac_lengths

    def u(*shape):
        return torch.rand(shape, generator=generator, device=gen_dev)

    draws = LossDraws(
        frac=lo + (hi - lo) * u(b), start=u(b),
        x0=torch.randn((b, n, c), generator=generator, device=gen_dev),
        t=u(b), drop_audio=u(b), drop_text=u(), drop_prompt=u(b))
    return LossDraws(*(x.to(device) for x in draws))


class CFM(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 cond_cfg: ConditioningConfig | None = None, *, device=None,
                 with_video2roll: bool = False, dropout_seed: int = 0,
                 text_num_embeds: int | None = None,
                 interpolated_text: bool = False):
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
        # the piano-perception net, built last so that the other parameters
        # draw the same initial values with or without it
        self.video2roll = (Video2RollNet(num_classes=cfg.notes, dtype=dtype,
                                         device=device)
                           if with_video2roll else None)
        # the token path: char / phoneme ids -> text stream (the shipped
        # configs feed CLIP features there instead)
        self.embed_text = None
        if text_num_embeds is not None:
            from v2ap_torch.models.duration import (
                CharacterEmbed, InterpolatedCharacterEmbed)
            klass = (InterpolatedCharacterEmbed if interpolated_text
                     else CharacterEmbed)
            self.embed_text = klass(cfg.dim_text, text_num_embeds,
                                    device=device)
        # every dropout draws from one generator on the model's device; a
        # structure-only build on the meta device (create_model_zeros) has
        # none, and its dropouts draw from the device's default generator
        self.dropout_generator = None
        if device.type != "meta":
            self.dropout_generator = torch.Generator(device=device)
            self.dropout_generator.manual_seed(dropout_seed)
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator

    def embed_tokens(self, tokens: torch.Tensor, length: int) -> torch.Tensor:
        """Token ids (b, nt), -1 padded -> text-stream features (b, length,
        dim_text), float32: the token path's conditioning."""
        if self.embed_text is None:
            raise ValueError("construct CFM with text_num_embeds for token "
                             "conditioning")
        return self.embed_text(tokens, length)

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
        deterministic: bool = True,
        collect_hidden_layer: Optional[int] = None,
    ):
        """One transformer evaluation -> predicted flow (b, n, C), float32.
        ``deterministic=False`` applies the transformer's dropouts.
        ``collect_hidden_layer`` (1-based) returns ``(pred, hiddens)``: the
        audio and CLIP-stream hiddens of that layer, for FactorCL."""
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
            context_mask=context_mask, deterministic=deterministic,
            collect_hidden_layer=collect_hidden_layer)
        if collect_hidden_layer is not None:
            out, hiddens = out
            return self.to_pred(out).float(), hiddens
        return self.to_pred(out).float()

    # ------------------------------------------------------------- perception
    def encode_frames(self, frames: torch.Tensor, length: int) -> torch.Tensor:
        """Keyboard frames (b, t, H, W) in [0, 1] -> roll probabilities
        (b, length, notes), float32.

        Edge-clamped ``piano_window``-frame windows through Video2RollNet, a
        sigmoid in float32, the repeat to the 75 Hz latent rate (x3 for 51
        keys; x2.5 for 88: x5, then the mean of adjacent pairs), then a trim
        or zero pad to ``length``."""
        if self.video2roll is None:
            raise ValueError("this CFM was built without Video2Roll "
                             "(with_video2roll=False)")
        b, t, hh, ww = frames.shape
        w = self.cond_cfg.piano_window
        half = w // 2
        # windows[:, i] = frames[:, clamp(i - half .. i + half)]
        idx = (torch.arange(t, device=frames.device)[:, None]
               + torch.arange(-half, w - half, device=frames.device)[None, :]
               ).clamp(0, t - 1)
        stacked = frames[:, idx].reshape(b * t, w, hh, ww)
        if self.cfg.remat and torch.is_grad_enabled():
            logits = torch.cat([
                remat(self.video2roll, stacked[i: i + V2R_REMAT_CHUNK])
                for i in range(0, b * t, V2R_REMAT_CHUNK)])
        else:
            logits = self.video2roll(stacked)
        probs = torch.sigmoid(logits.float())
        probs = probs.reshape(b, t, self.cfg.notes)
        vm = self.cfg.video_multi
        if float(vm).is_integer():
            probs = probs.repeat_interleave(int(vm), dim=1)
        else:
            num, den = float(vm).as_integer_ratio()           # 5, 2
            rep = probs.repeat_interleave(num, dim=1)
            t5 = (rep.shape[1] // den) * den
            probs = rep[:, :t5].reshape(b, t5 // den, den,
                                        self.cfg.notes).mean(dim=2)
        cur = probs.shape[1]
        if cur > length:
            probs = probs[:, :length]
        elif cur < length:
            probs = F.pad(probs, (0, 0, 0, length - cur))
        return probs

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

    def sample_multipass(
        self,
        x0: torch.Tensor,                       # (b, n, C) gaussian noise
        *,
        passes: int = 2,
        restart_t: float = 0.6,
        refine_steps: Optional[int] = None,
        noises: Optional[torch.Tensor] = None,  # (passes - 1, b, n, C)
        generator: Optional[torch.Generator] = None,
        text_embed: torch.Tensor,
        frames_embed: torch.Tensor,
        context: Optional[torch.Tensor],
        context_mask: Optional[torch.Tensor],
        mask: Optional[torch.Tensor],
        sampler: SamplerConfig,
        drop_prompt: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Restart sampling: the full ODE pass, then ``passes - 1`` times
        re-noise the result to ``restart_t`` along the flow path,
        x = (1 - restart_t) noise + restart_t out, and integrate
        restart_t -> 1 over ``refine_steps`` (default max(steps // 2, 2))
        sway steps mapped onto [restart_t, 1]. Pass p's noise is
        ``noises[p - 1]``; without ``noises`` all of them are drawn from
        ``generator`` (float32, on x0's device) before the first step."""
        if noises is None and passes > 1:
            noises = torch.randn((passes - 1,) + tuple(x0.shape),
                                 generator=generator, device=x0.device)
        out = self.sample(x0, text_embed=text_embed, frames_embed=frames_embed,
                          context=context, context_mask=context_mask,
                          mask=mask, sampler=sampler, drop_prompt=drop_prompt)
        fn = self._make_cfg_fn(
            batch=x0.shape[0], text_embed=text_embed,
            frames_embed=frames_embed, context=context,
            context_mask=context_mask, mask=mask, sampler=sampler,
            drop_prompt=drop_prompt)
        steps = refine_steps or max(sampler.steps // 2, 2)
        base = sway_timesteps(steps, sampler.sway_sampling)
        # float32 as in JAX: restart_t + (1 - restart_t) * base
        ts = np.float32(restart_t) + np.float32(1.0 - restart_t) * base
        for p in range(1, passes):
            x = (1.0 - restart_t) * noises[p - 1].float() + restart_t * out
            out = euler_integrate(fn, x, ts, method=sampler.method)
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

    # ------------------------------------------------------------------ loss
    def loss(
        self,
        x1: torch.Tensor,                       # (b, n, C) target latents
        *,
        lens: torch.Tensor,                     # (b,)
        text_embed: torch.Tensor,               # (b, n, dim_text)
        context: Optional[torch.Tensor],        # (b, nc, dim_context)
        context_mask: Optional[torch.Tensor],   # (b, nc)
        generator: Optional[torch.Generator] = None,
        draws: Optional[LossDraws] = None,
        frames: Optional[torch.Tensor] = None,  # (b, t, H, W) in [0, 1]
        midis: Optional[torch.Tensor] = None,   # (b, n, notes) gt roll
        times=None,                             # fixed times (val) or None
        x0: Optional[torch.Tensor] = None,      # coupled noise, else drawn
        val: bool = False,
        midi_loss_weight: float = 10.0,
        train_video_encoder: bool = True,
        use_midi_gt: bool = False,
        collect_hidden_layer: Optional[int] = None,
        psum=None,
    ) -> CFMOutput:
        """Flow-matching training objective: span mask, x0 and t,
        w = (1-t) x0 + t x1 against the flow x1 - x0, per-sample dropout of
        the audio condition, the CLIP stream (one draw for the batch) and
        the prompt, dropout in the transformer unless ``val``. The random
        values come from ``draws`` if given, else from
        ``draw_loss_randoms`` on ``generator``.

        With keyboard ``frames`` and their ground-truth roll ``midis``,
        Video2Roll's roll feeds the frames stream and the MIDI loss
        sum(mask * |midis - 0.1| * (roll - midis)^2) / max(valid * notes, 1)
        adds ``midi_loss_weight`` times itself to the total;
        ``train_video_encoder=False`` feeds the ground truth instead and
        adds no MIDI loss, ``use_midi_gt`` feeds the ground truth while
        still training Video2Roll. ``collect_hidden_layer`` puts that
        layer's (audio, CLIP-stream) hiddens in ``CFMOutput.hiddens``.

        ``psum`` (the data-parallel train step's sum over the data group,
        its gradient passed through) reduces each masked sum and masked
        count, and the roll metrics' counts, before the ratio: the losses
        are the global batch's, not a mean of the ranks' means."""
        psum = psum or (lambda t: t)
        cc = self.cond_cfg
        b, n, c = x1.shape
        dev = x1.device
        lens = lens.to(dev)
        mask = lens_to_mask(lens, n)
        if draws is None:
            draws = draw_loss_randoms(b, n, c, cc.frac_lengths_mask,
                                      generator=generator, device=dev)
        no_audio_cond = cc.audiocond_drop_prob > 1.0
        lo, hi = cc.frac_lengths_mask
        if not val:
            frac = torch.ones(b, device=dev) if no_audio_cond else draws.frac
            start_rand = draws.start
        else:
            frac = torch.full((b,), (lo + hi) / 2.0, device=dev)
            start_rand = torch.full((b,), 0.5, device=dev)
        span_mask = mask_from_frac_lengths(lens, frac, n, start_rand) & mask

        x0 = draws.x0 if x0 is None else x0.float()
        x1 = x1.float()
        t = (draws.t if times is None else
             torch.as_tensor(times, dtype=torch.float32, device=dev).expand(b))
        tb = t[:, None, None]
        w = (1.0 - tb) * x0 + tb * x1
        flow = x1 - x0
        cond = (None if no_audio_cond
                else torch.where(span_mask[..., None], 0.0, x1))
        zero = torch.zeros((), device=dev)
        loss_midi = pre = rec = f1 = acc = zero
        if frames is None:
            frames_embed = torch.zeros(b, n, self.cfg.notes, device=dev)
        else:
            midis_eff = midis.to(dev).float()
            frames_embed = midis_eff
            if train_video_encoder:
                roll = self.encode_frames(frames.to(dev), n)
                per = (roll - midis_eff) ** 2 * (midis_eff - 0.10).abs()
                num = torch.where(mask[..., None], per, 0.0).sum()
                loss_midi = psum(num) / torch.clamp(
                    psum(mask.sum() * self.cfg.notes), min=1)
                pre, rec, f1, acc = roll_metrics(roll, midis_eff, mask, psum)
                if not use_midi_gt:
                    frames_embed = roll

        if not val:
            drop_audio = draws.drop_audio < cc.audiocond_drop_prob
            drop_text = draws.drop_text < cc.cond_drop_prob
            drop_prompt = draws.drop_prompt < cc.prompt_drop_prob
        else:
            drop_audio = drop_prompt = torch.zeros(b, dtype=torch.bool,
                                                   device=dev)
            drop_text = torch.zeros((), dtype=torch.bool, device=dev)
        if cond is not None:
            cond = torch.where(drop_audio[:, None, None], 0.0, cond)
        text_in = torch.where(drop_text, 0.0, text_embed)
        ctx_in = (None if context is None else
                  torch.where(drop_prompt[:, None, None], 0.0, context))

        pred = self.pred_head(
            w, cond, times=t, mask=mask, text_embed=text_in,
            frames_embed=frames_embed, context=ctx_in,
            context_mask=context_mask, deterministic=val,
            collect_hidden_layer=collect_hidden_layer)
        hiddens = None
        if collect_hidden_layer is not None:
            pred, hiddens = pred
        per = (pred - flow) ** 2
        loss_flow = psum(torch.where(span_mask[..., None], per, 0.0).sum()) / \
            torch.clamp(psum(span_mask.sum() * c), min=1)
        per_sample = (per.mean(-1) * span_mask).mean(-1)
        breakdown = LossBreakdown(loss_flow, loss_midi, pre, rec, f1, acc)
        return CFMOutput(loss_flow + loss_midi * midi_loss_weight, pred,
                         x0 + pred, breakdown, per_sample_flow=per_sample,
                         hiddens=hiddens)

    def forward(self, *args, **kwargs) -> CFMOutput:
        """The training objective, ``loss``: a module call, so that
        ``torch.func.functional_call`` can run it on other parameters (the
        DPO reference scores under the EMA shadow)."""
        return self.loss(*args, **kwargs)


def roll_metrics(probs: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 psum=None):
    """Precision, recall, F1 and accuracy of a roll at 25 Hz: rolls and
    mask mean-pooled over 3 frames, a note on where the prediction is
    >= 0.4 and the ground truth >= 0.5, pooled frames whose mask mean is
    >= 0.99 counted; each 0 where its denominator is. ``psum`` sums the
    counts over the data group (the global batch's metrics)."""
    psum = psum or (lambda t: t)
    b, t, f = probs.shape
    t3 = (t // 3) * 3
    p3 = probs[:, :t3].reshape(b, t3 // 3, 3, f).mean(dim=2)
    g3 = gt[:, :t3].reshape(b, t3 // 3, 3, f).mean(dim=2)
    m3 = (mask[:, :t3].reshape(b, t3 // 3, 3).float().mean(dim=2)
          >= 0.99)[..., None]
    tp = psum(((p3 >= 0.4) & (g3 >= 0.5) & m3).sum().float())
    fp = psum(((p3 >= 0.4) & (g3 < 0.5) & m3).sum().float())
    fn = psum(((p3 < 0.4) & (g3 >= 0.5) & m3).sum().float())

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1), 0.0)

    return (ratio(tp, tp + fp), ratio(tp, tp + fn),
            ratio(2 * tp, 2 * tp + fp + fn), ratio(tp, tp + fp + fn))
