"""FactorCL-style contrastive audio <-> video alignment loss (the variant-6
model, ``crossatt6``).

Counterpart of ``v2ap_tpu/training/contrastive.py``: the layer-1 audio and
CLIP-stream hiddens of the batch's rows 2..8 at one random timestep are
L2-normalised, projected by small MLP heads, concatenated with a one-hot
row label and scored by a CLUB critic (contrastive log-ratio upper bound);
the critic's InfoNCE "learning loss" trains the critic itself. The heads
and the critic hold float32 parameters and compute in float32.
``TrainConfig.contrastive`` folds the loss into ``Trainer``'s step, which
is what training runs; ``make_contrastive_train_step`` mirrors JAX's
standalone step, which no entry point calls in either package, and only
the tests use it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import Linear
from v2ap_torch.ops.sampling import lens_to_mask
from v2ap_torch.utils.device import resolve_device


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(|x|, eps) over the last axis, in x's dtype (as JAX's)."""
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=eps * eps))


class MLPHead(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(dim, dim, device=device)
        self.fc2 = Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class CLUBCritic(nn.Module):
    """Scalar critic f([y, x]); the CLUB bound and the InfoNCE learning
    loss over all (y_i, x_j) pairs of a batch."""

    def __init__(self, a_dim: int, b_dim: int, hidden: int = 512, *,
                 device=None):
        super().__init__()
        self.fc1 = Linear(a_dim + b_dim, hidden, device=device)
        self.fc2 = Linear(hidden, 1, device=device)

    def _f(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))

    def _scores(self, x: torch.Tensor, y: torch.Tensor):
        n = x.shape[0]
        t0 = self._f(torch.cat([y, x], -1))                     # (n, 1) paired
        x_tile = x[None].expand(n, n, x.shape[-1])
        y_tile = y[:, None].expand(n, n, y.shape[-1])
        t1 = self._f(torch.cat([y_tile, x_tile], -1))           # (n, n, 1)
        return t0, t1

    def club(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        t0, t1 = self._scores(x, y)
        return -(t0.mean() - t1.mean())

    def infonce_learning_loss(self, x: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
        t0, t1 = self._scores(x, y)
        n = x.shape[0]
        lower = t0.mean() - (torch.logsumexp(t1[..., 0], dim=1).mean()
                             - math.log(n))
        return -lower


class FactorCL(nn.Module):
    """Audio-hidden x CLIP-hidden conditional CLUB loss with one-hot row
    labels (the reference's ``FactorCLSUP(None, [dim, dim_text], 6)``).
    ``device=None`` means CUDA."""

    def __init__(self, dim_a: int, dim_b: int, num_labels: int = 6, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_labels = num_labels
        self.head_a = MLPHead(dim_a, device=device)
        self.head_b = MLPHead(dim_b, device=device)
        self.critic = CLUBCritic(dim_a + num_labels, dim_b + num_labels,
                                 device=device)

    def _project(self, a, b, labels):
        a = self.head_a(_l2norm(a))
        b = self.head_b(_l2norm(b))
        ohe = F.one_hot(labels, self.num_labels).float()
        return torch.cat([a, ohe], -1), torch.cat([b, ohe], -1)

    def forward(self, audio_feats: torch.Tensor, clip_feats: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """(n, dim_a), (n, dim_b), (n,) int labels -> scalar CLUB loss."""
        a, b = self._project(audio_feats, clip_feats, labels)
        return self.critic.club(a, b)

    def learning_loss(self, audio_feats: torch.Tensor,
                      clip_feats: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        a, b = self._project(audio_feats, clip_feats, labels)
        return self.critic.infonce_learning_loss(a, b)


# optax.adamw's default weight decay, which JAX's FactorCL optimizer keeps
# (the main optimizer passes 0.01)
FCL_WEIGHT_DECAY = 1e-4


class FactorCLAdamW:
    """JAX's FactorCL optimizer, ``optax.adamw(lr)``: a constant ``lr``, b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4, no clip. A parameter
    without a gradient (the contrastive term gated off) takes a zero one,
    so its weight still decays, as in optax."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=FCL_WEIGHT_DECAY)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.adamw.step()

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def draw_feature_index(n: int, *, generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """The timestep ``sample_contrastive_features`` picks: uniform in
    [0, n), a 0-d int64 tensor drawn from ``generator``."""
    gen_dev = generator.device if generator is not None else "cpu"
    return torch.randint(0, n, (), generator=generator,
                         device=gen_dev).to(device)


def sample_contrastive_features(audio_hidden: torch.Tensor,
                                text_hidden: torch.Tensor,
                                num_registers: int,
                                t: Optional[torch.Tensor] = None, *,
                                generator: Optional[torch.Generator] = None,
                                rows: slice = slice(2, 8)) -> tuple:
    """The reference's feature rows: batch rows 2..8 of the layer's
    hiddens, registers stripped, at timestep ``t`` (a 0-d index; drawn
    with ``draw_feature_index`` from ``generator`` when None); returns
    (audio, clip, labels 0..rows-1)."""
    a = audio_hidden[rows, num_registers:, :]
    b = text_hidden[rows, num_registers:, :]
    if t is None:
        t = draw_feature_index(a.shape[1], generator=generator,
                               device=a.device)
    t = t.to(a.device)
    labels = torch.arange(a.shape[0], device=a.device)
    return a[:, t, :], b[:, t, :], labels


class ContrastiveDraws(NamedTuple):
    """The standalone step's random draws, in JAX's key order."""
    x0: torch.Tensor        # (b, n, c)
    t: torch.Tensor         # (b,)
    feature_t: torch.Tensor  # () the hiddens' timestep


def make_contrastive_train_step(fcl: FactorCL, *, layer: int = 1,
                                weight: float = 1.0, min_batch: int = 8):
    """The variant-6 step ``step(model, fcl, optimizer, fcl_opt, batch, *,
    generator=None, draws=None) -> (loss, loss_fm, loss_con)``: the masked
    flow-matching loss (no span, no condition dropout, no transformer
    dropout) plus ``weight`` times FactorCL's CLUB bound and learning loss
    on the layer-``layer`` hiddens of rows 2..8, only when the batch has at
    least ``min_batch`` rows. One backward; ``optimizer`` updates the CFM,
    ``fcl_opt`` FactorCL."""

    def step(model, fcl_mod: FactorCL, optimizer, fcl_opt, batch: dict, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[ContrastiveDraws] = None):
        x1 = batch["latents"].float()
        dev = x1.device
        lens = batch["lens"].to(dev)
        b, n, c = x1.shape
        mask = lens_to_mask(lens, n)
        if draws is None:
            gen_dev = generator.device if generator is not None else "cpu"
            x0 = torch.randn((b, n, c), generator=generator, device=gen_dev)
            t = torch.rand((b,), generator=generator, device=gen_dev)
            draws = ContrastiveDraws(
                x0.to(dev), t.to(dev),
                draw_feature_index(n, generator=generator, device=dev))
        tb = draws.t[:, None, None]
        w = (1.0 - tb) * draws.x0 + tb * x1
        flow = x1 - draws.x0
        optimizer.zero_grad()
        fcl_opt.zero_grad()
        pred, (ah, th) = model.pred_head(
            w, None, times=draws.t, mask=mask,
            text_embed=batch["text_embed"],
            frames_embed=torch.zeros(b, n, model.cfg.notes, device=dev),
            context=batch.get("context"),
            context_mask=batch.get("context_mask"),
            collect_hidden_layer=layer)
        loss_fm = torch.where(mask[..., None], (pred - flow) ** 2, 0.0).sum() \
            / torch.clamp(mask.sum() * c, min=1)
        if b >= min_batch:
            fa, fb, labels = sample_contrastive_features(
                ah, th, model.cfg.num_registers, draws.feature_t)
            loss_con = fcl_mod(fa, fb, labels) + fcl_mod.learning_loss(
                fa, fb, labels)
        else:
            loss_con = torch.zeros((), device=dev)
        total = loss_fm + weight * loss_con
        total.backward()
        optimizer.step()
        fcl_opt.step()
        return total.detach(), loss_fm.detach(), loss_con.detach()

    return step
