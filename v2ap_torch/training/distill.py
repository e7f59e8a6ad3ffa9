"""Few-step sampling through rectified-flow reflow distillation.

Counterpart of ``v2ap_tpu/training/distill.py``: the teacher's guided ODE
(its ``sample``, 25 sway steps with CFG 2.0 by default) turns gaussian x0
into x1; the student (the same architecture, usually initialised from the
teacher's weights) is fine-tuned with the flow-matching loss on the
coupled pair (``CFM.loss(x0=...)``), which straightens the flow so that a
few Euler steps without CFG (``fewstep_sampler``) reproduce what took 25
guided ones. The optimizer is optax's ``chain(clip_by_global_norm(
grad_clip), adamw(schedule))``: the trainer's warm-up from 0.01 lr to lr
joined to a decay back to 0.01 lr, and optax's default weight decay 1e-4.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from v2ap_torch.config import SamplerConfig, TrainConfig
from v2ap_torch.config import fewstep_sampler  # noqa: F401  (its API too)
from v2ap_torch.models.cfm import CFM, LossDraws
from v2ap_torch.training.trainer import ClippedAdamW

# optax.adamw's default, which JAX's distiller keeps
REFLOW_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass(frozen=True)
class ReflowConfig:
    learning_rate: float = 1e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    grad_clip: float = 1.0
    teacher_steps: int = 25              # ODE steps when drawing pairs
    cfg_strength: float = 2.0            # guidance baked into the pairs


def make_pair_sampler(teacher: CFM, cfg: ReflowConfig) -> Callable:
    """``pairs(text_embed, frames_embed, context, context_mask, mask, *,
    generator=None, x0=None) -> (x0, x1)``: gaussian x0 (float32, drawn
    from ``generator`` on the teacher's device unless given) integrated by
    the teacher's sway-scheduled CFG sampler, without autograd. The
    guidance is baked into x1, so the student learns the guided flow and
    samples without CFG."""
    sampler = SamplerConfig(steps=cfg.teacher_steps,
                            cfg_strength=cfg.cfg_strength,
                            sway_sampling=True)

    @torch.no_grad()
    def pairs(text_embed, frames_embed, context, context_mask, mask, *,
              generator: Optional[torch.Generator] = None,
              x0: Optional[torch.Tensor] = None):
        if x0 is None:
            b, n, _ = text_embed.shape
            x0 = torch.randn((b, n, teacher.cfg.num_channels),
                             generator=generator, device=text_embed.device)
        x1 = teacher.sample(x0, text_embed=text_embed,
                            frames_embed=frames_embed, context=context,
                            context_mask=context_mask, mask=mask,
                            sampler=sampler)
        return x0, x1

    return pairs


class ReflowDistiller:
    """Owns the student, its optimizer and the generator of its loss's
    draws (seeded ``seed``, on the student's device)."""

    def __init__(self, student: CFM, cfg: ReflowConfig | None = None, *,
                 seed: int = 0):
        self.cfg = cfg or ReflowConfig()
        self.student = student
        schedule = TrainConfig(learning_rate=self.cfg.learning_rate,
                               warmup_steps=self.cfg.warmup_steps,
                               decay_steps=self.cfg.decay_steps,
                               grad_clip=self.cfg.grad_clip)
        self.optimizer = ClippedAdamW(student.parameters(), schedule,
                                      weight_decay=REFLOW_WEIGHT_DECAY)
        device = next(student.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.step = 0

    def distill_step(self, x0: torch.Tensor, x1: torch.Tensor, *, lens,
                     text_embed, context, context_mask,
                     draws: Optional[LossDraws] = None) -> torch.Tensor:
        """One step of the student's flow-matching loss on the coupled pair
        (training mode: span, condition and transformer dropouts), its
        draws from ``draws`` or the distiller's generator; returns the loss."""
        self.optimizer.zero_grad()
        out = self.student.loss(x1, lens=lens, text_embed=text_embed,
                                context=context, context_mask=context_mask,
                                generator=self.generator, draws=draws, x0=x0)
        out.loss.backward()
        self.optimizer.step()
        self.step += 1
        return out.loss.detach()

