"""Failure detection and recovery for long training runs.

Counterpart of ``v2ap_tpu/training/resilience.py``:

  * ``GradGuard``   — a step with a non-finite loss or gradient updates the
    optimizer with zero gradients instead (a poisoned batch cannot corrupt
    the parameters), and too many such steps in a row raise;
  * ``Watchdog``    — a heartbeat file for external supervisors and stall
    detection;
  * ``AutoResumer`` — periodic exact-state checkpoints through
    ``CheckpointManager`` and resume at the saved step.
"""

from __future__ import annotations

import json
import os
import time

import torch

from v2ap_torch.utils.checkpoint import CheckpointManager


class GradGuard:
    def __init__(self, max_consecutive_skips: int = 50):
        self.skipped = 0
        self.consecutive = 0
        self.max_consecutive = max_consecutive_skips

    @torch.no_grad()
    def apply(self, optimizer, loss: torch.Tensor) -> bool:
        """Step ``optimizer`` (``ClippedAdamW``: its ``params`` hold the
        gradients) when ``loss`` and every gradient are finite, else step it
        with zero gradients. Returns whether the gradients were applied."""
        grads = [p.grad for p in optimizer.params if p.grad is not None]
        finite = torch.isfinite(loss).all()
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        ok = bool(finite)
        if not ok:
            for g in grads:
                g.zero_()
        optimizer.step()
        if ok:
            self.consecutive = 0
        else:
            self.skipped += 1
            self.consecutive += 1
            if self.consecutive >= self.max_consecutive:
                raise RuntimeError(
                    f"{self.consecutive} consecutive non-finite steps — "
                    "training diverged")
        return ok


class Watchdog:
    """Heartbeat file for external supervisors; detects stalls."""

    def __init__(self, path: str, stall_seconds: float = 1800.0):
        self.path = path
        self.stall_seconds = stall_seconds
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.beat(step=0)

    def beat(self, step: int, **extra) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update(extra)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_stalled(path: str, stall_seconds: float = 1800.0) -> bool:
        try:
            with open(path) as f:
                rec = json.load(f)
            return time.time() - rec["time"] > stall_seconds
        except Exception:
            return True


class AutoResumer:
    """Periodic exact-state checkpoints of a ``Trainer`` and resume."""

    def __init__(self, trainer, ckpt_dir: str, save_every: int = 1000,
                 max_to_keep: int = 3):
        self.trainer = trainer
        self.save_every = save_every
        self.mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint, if any; returns its step (0 if
        none)."""
        if self.mgr.latest_step() is None:
            return 0
        return self.mgr.restore(self.trainer)

    def maybe_save(self) -> bool:
        step = self.trainer.step
        if step % self.save_every != 0 or step == 0:
            return False
        self.mgr.save(step, self.trainer)
        return True
