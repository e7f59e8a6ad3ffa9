"""DPO-style preference optimization with an optional velocity-consistency
regulariser.

Counterpart of ``v2ap_tpu/training/dpo.py``: the last two rows of a batch
are the winner and the loser of a preference pair; the policy and a frozen
reference model score every row with the per-sample span-masked flow loss
at shared (t, x0, span) draws, and

    DPO = -logsigmoid(scale * ((w - l) - (w_ref - l_ref)))

with the reference's scale -1 (the winner's loss should drop relative to
the reference model's). ``velocity_consistency_weight`` > 0 adds
MSE(ref_pred, flow) times itself (off at the default). ``TrainConfig.dpo``
folds the same pair loss into ``Trainer``'s step
(``v2ap_torch.training.trainer``), which is what training runs;
``make_dpo_train_step`` mirrors JAX's standalone step, which no entry
point calls in either package, and only the tests use it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from v2ap_torch.models.cfm import CFM
from v2ap_torch.ops.sampling import lens_to_mask, mask_from_frac_lengths


def per_sample_flow_loss(pred: torch.Tensor, flow: torch.Tensor,
                         span_mask: torch.Tensor) -> torch.Tensor:
    """(b, n, c) -> (b,): feature-mean MSE averaged over the masked span."""
    per = ((pred - flow) ** 2).mean(-1)                   # (b, n)
    num = torch.where(span_mask, per, 0.0).sum(-1)
    den = torch.clamp(span_mask.sum(-1), min=1)
    return num / den


def dpo_pair_loss(w: torch.Tensor, l: torch.Tensor, w_ref: torch.Tensor,
                  l_ref: torch.Tensor, scale: float = -1.0) -> torch.Tensor:
    inside = scale * ((w - l) - (w_ref - l_ref))
    return -F.logsigmoid(inside).mean()


class DPODraws(NamedTuple):
    """The standalone step's random draws, in JAX's key order (its first
    key, the span fraction, goes unused: the span is the full length)."""
    start: torch.Tensor     # (b,) span start
    x0: torch.Tensor        # (b, n, c)
    t: torch.Tensor         # (b,)


def draw_dpo_randoms(b: int, n: int, c: int, *,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> DPODraws:
    gen_dev = generator.device if generator is not None else "cpu"
    draws = DPODraws(
        start=torch.rand((b,), generator=generator, device=gen_dev),
        x0=torch.randn((b, n, c), generator=generator, device=gen_dev),
        t=torch.rand((b,), generator=generator, device=gen_dev))
    return DPODraws(*(x.to(device) for x in draws))


def make_dpo_train_step(*, dpo_scale: float = -1.0,
                        velocity_consistency_weight: float = -1e-5):
    """The preference-optimization step ``step(model, ref_model, optimizer,
    batch, *, generator=None, draws=None) -> (loss, loss_fm, loss_dpo)``.
    Rows [:-2] of the batch are ordinary samples, rows [-2] / [-1] the
    winner / loser of a pair sharing the same conditioning. The span is
    the full length, the transformer runs without dropout, and the
    reference model scores under ``no_grad``. ``optimizer`` is the port's
    ``ClippedAdamW`` (or anything with ``zero_grad`` and ``step``)."""

    def step(model: CFM, ref_model: CFM, optimizer, batch: dict, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[DPODraws] = None):
        x1 = batch["latents"].float()
        dev = x1.device
        lens = batch["lens"].to(dev)
        b, n, c = x1.shape
        mask = lens_to_mask(lens, n)
        if draws is None:
            draws = draw_dpo_randoms(b, n, c, generator=generator, device=dev)
        frac = torch.ones(b, device=dev)
        span = mask_from_frac_lengths(lens, frac, n, draws.start) & mask
        tb = draws.t[:, None, None]
        w = (1.0 - tb) * draws.x0 + tb * x1
        flow = x1 - draws.x0
        frames = batch.get("frames_roll")
        if frames is None:
            frames = torch.zeros(b, n, model.cfg.notes, device=dev)

        def fwd(m: CFM) -> torch.Tensor:
            return m.pred_head(
                w, None, times=draws.t, mask=mask,
                text_embed=batch["text_embed"], frames_embed=frames,
                context=batch.get("context"),
                context_mask=batch.get("context_mask"))

        with torch.no_grad():
            ref_pred = fwd(ref_model)
            ref_losses = per_sample_flow_loss(ref_pred, flow, span)
        optimizer.zero_grad()
        sample_losses = per_sample_flow_loss(fwd(model), flow, span)
        loss_fm = sample_losses.mean()
        loss_dpo = dpo_pair_loss(sample_losses[-2], sample_losses[-1],
                                 ref_losses[-2], ref_losses[-1],
                                 scale=dpo_scale)
        total = loss_fm + loss_dpo
        if velocity_consistency_weight > 0:
            total = total + velocity_consistency_weight * torch.mean(
                (ref_pred - flow) ** 2)
        total.backward()
        optimizer.step()
        return total.detach(), loss_fm.detach(), loss_dpo.detach()

    return step
