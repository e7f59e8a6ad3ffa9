"""Training for the port: the V2A / V2P flow-matching train step, AdamW
with optax's schedule and clip (a bf16 first moment optionally), EMA, with
DPO (``dpo``) and FactorCL (``contrastive``) folded in; reflow
distillation (``distill``); ``pipeline.TrainingPipeline`` (corpora to
checkpoints) and ``resilience`` (heartbeat, resume, non-finite guard)."""

from v2ap_torch.training.trainer import (
    EMA, ClippedAdamW, Trainer, make_eval_step, make_lr_schedule,
    make_train_step, make_tx,
)

__all__ = ["EMA", "ClippedAdamW", "Trainer", "make_eval_step",
           "make_lr_schedule", "make_train_step", "make_tx"]
