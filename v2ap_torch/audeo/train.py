"""Training loops for the Audeo subsystem.

Counterpart of ``v2ap_tpu/audeo/train.py``:

* Video2Roll: BCE-with-logits multilabel training (the mean over keys and
  windows) with Adam 1e-3, BatchNorm on the batch statistics, and the
  bad-epoch counter of a plateau schedule, which changes no learning rate
  (reference: Video2Roll_train.py:12-26, Video2Roll_solver.py:42-144).
* Roll2Midi: LSGAN training. G loss = 0.001 * MSE(D(fake), 1) + 0.999 *
  MSE(fake, gt) with the generator in training mode (batch statistics,
  dropout); D loss = (MSE(D(real), 1) + MSE(D(fake), 0)) / 2 on the updated
  generator's output in eval mode (reference: Roll2Midi_train.py:52-110,
  221-233).

Both use ``torch.optim.Adam`` with b1 0.9, b2 0.999 and eps 1e-8, which is
optax's ``adam``: bias-corrected moments, eps added outside the square
root. The optimizers take the parameters only; BatchNorm's running
statistics are buffers, as they are ``BatchStat`` outside ``nnx.Param`` in
JAX. Each step runs on the models' device.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from v2ap_torch.audeo.roll2midi import Roll2MidiDiscriminator, Roll2MidiGenerator
from v2ap_torch.models.video2roll import Video2RollNet

ADV_WEIGHT = 0.001


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


# ------------------------------------------------------------- video2roll

class Video2RollTrainer:
    """Epoch loop with the plateau counter and best-F1 slot of JAX's."""

    def __init__(self, model: Video2RollNet, lr: float = 1e-3,
                 patience: int = 2):
        self.model = model
        self.optimizer = _adam(model.parameters(), lr)
        self.best_f1 = 0.0
        self.patience = patience
        self._bad_epochs = 0
        self.history = []

    def step(self, frames, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on (b, 5, H, W) windows and (b, keys) labels: (the
        loss, the logits), both detached on the model's device."""
        dev = next(self.model.parameters()).device
        logits = self.model(torch.as_tensor(frames, device=dev), train=True)
        loss = F.binary_cross_entropy_with_logits(
            logits, torch.as_tensor(labels, device=dev).float())
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logits.detach()

    def train_epoch(self, batches: Iterator[tuple],
                    max_steps: int | None = None) -> float:
        total, n = 0.0, 0
        for i, (frames, labels) in enumerate(batches):
            if max_steps is not None and i >= max_steps:
                break
            loss, _ = self.step(frames, labels)
            total += float(loss)
            n += 1
        avg = total / max(n, 1)
        self.history.append(avg)
        if len(self.history) > 1 and avg >= self.history[-2]:
            self._bad_epochs += 1
        else:
            self._bad_epochs = 0
        return avg


# --------------------------------------------------------------- roll2midi

class Roll2MidiTrainer:
    def __init__(self, gen: Roll2MidiGenerator, disc: Roll2MidiDiscriminator,
                 g_lr: float = 5e-4, d_lr: float = 1e-3):
        self.gen, self.disc = gen, disc
        self.g_opt = _adam(gen.parameters(), g_lr)
        self.d_opt = _adam(disc.parameters(), d_lr)

    def step(self, roll, gt) -> Tuple[float, float, float, float]:
        """One G update, then one D update, on (b, keys, frames, 1) windows:
        (G loss, D loss, adversarial term, reconstruction term)."""
        dev = next(self.gen.parameters()).device
        roll = torch.as_tensor(roll, device=dev)
        gt = torch.as_tensor(gt, device=dev)
        fake = self.gen(roll, train=True, deterministic=False)
        adv = (self.disc(fake) - 1.0).pow(2).mean()
        rec = (fake - gt).pow(2).mean()
        g_loss = ADV_WEIGHT * adv + (1.0 - ADV_WEIGHT) * rec
        self.g_opt.zero_grad(set_to_none=True)
        g_loss.backward(inputs=list(self.gen.parameters()))
        self.g_opt.step()

        with torch.no_grad():
            fake = self.gen(roll, train=False)
        d_loss = 0.5 * ((self.disc(gt) - 1.0).pow(2).mean()
                        + self.disc(fake).pow(2).mean())
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_opt.step()
        return g_loss.item(), d_loss.item(), adv.item(), rec.item()
