"""Training loop: AdamW with a warmup -> decay schedule, global-norm clip,
gradient accumulation and EMA, for V2A batches and V2P batches (keyboard
frames and their ground-truth roll, the MIDI loss).

Counterpart of ``v2ap_tpu/training/trainer.py``. The optimizer reproduces
``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1=0.9,
b2=0.999, weight_decay=0.01, mu_dtype=bf16 if mu_bf16 else None))``:
optax's schedule arithmetic (step 0 uses 0.01 * lr, the decay starts at
``warmup_steps``), optax's clip g * min(1, max_norm / |g|)
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is not
used), and AdamW over every parameter, with a zero gradient where a
parameter took no part in the loss (optax still decays its weight). With
``mu_bf16`` the first moment is stored in bf16 and the update is optax's
arithmetic on its float32 value (``torch.optim.AdamW`` cannot do that),
else ``torch.optim.AdamW`` runs. The step runs eagerly and updates the
model in place; remat is the model's (``ModelConfig.remat``). DPO (the
EMA shadow as the reference model) and FactorCL fold into the same step.
``Trainer.state_dict`` / ``load_state_dict`` carry the exact training
state (parameters, buffers, the model's dropout generator, the optimizer's
moments and count, the EMA shadow, FactorCL and its optimizer, the step)
for ``v2ap_torch.utils.checkpoint``.

Under a mesh (``Trainer(mesh=)``, the counterpart of JAX's ``jit`` over a
sharded batch) the model is sharded by ``parallel.shard_model`` and each
rank takes its data index's rows of every micro-batch. Every rank draws
the global micro-batch's seven loss values (and the dropout masks) from
the same generator and takes its rows, so the step equals the unsharded
one. The flow and MIDI losses are a masked sum over a masked count of
the global batch, both summed over the data group (``CFM.loss(psum=)``);
DPO's per-sample scores and FactorCL's hiddens are gathered over it (the
pair is the global micro-batch's last two rows, the critic replicated).
Gradients of partly-used replicated parameters are summed over the model
group, then every gradient over the data group; the clip's global norm
sums the squares of the shards over the model group and counts replicated
tensors once; AdamW and EMA act on the local shards. ``state_dict``
gathers the shards (the state is the unsharded one) and
``load_state_dict`` shards it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from v2ap_torch.config import TrainConfig
from v2ap_torch.models.cfm import (CFM, LossBreakdown, LossDraws,
                                   draw_loss_randoms)
from v2ap_torch.training.contrastive import (FactorCL, FactorCLAdamW,
                                             sample_contrastive_features)
from v2ap_torch.parallel import distributed as pd
from v2ap_torch.parallel.mesh import batch_sharding, mesh_axes
from v2ap_torch.parallel.sharding import shard_model
from v2ap_torch.parallel.state import (full_state_dict, gather_like,
                                       load_full_state_dict, shard_like)
from v2ap_torch.training.dpo import dpo_pair_loss
from v2ap_torch.utils.device import seeded_init


def _linear_schedule(init: float, end: float, steps: int) -> Callable:
    """optax.linear_schedule in float32: init -> end over ``steps``."""
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) \
            / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return schedule


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup 0.01 lr -> lr over ``warmup_steps``, then linear decay
    lr -> 0.01 lr over ``decay_steps`` (optax.join_schedules)."""
    warmup = _linear_schedule(cfg.learning_rate * 0.01, cfg.learning_rate,
                              cfg.warmup_steps)
    decay = _linear_schedule(cfg.learning_rate, cfg.learning_rate * 0.01,
                             cfg.decay_steps)

    def schedule(step: int) -> float:
        return (warmup(step) if step < cfg.warmup_steps
                else decay(step - cfg.warmup_steps))
    return schedule


def sharded_global_norm(tensors: Sequence[torch.Tensor],
                        sharded: Sequence[bool], group=None) -> torch.Tensor:
    """The global norm of ``tensors``, some of which (``sharded``) may be
    tensor-parallel shards over ``group``: the shards' squares summed over
    the group, the rest counted once. ``group`` None: no reduction (no
    tensor is sharded, or the model group is of one rank)."""
    def sq(ts):
        if not ts:
            return torch.zeros((), device=tensors[0].device)
        return torch.stack(torch._foreach_norm(ts)).square().sum()

    part = sq([t for t, s in zip(tensors, sharded) if s])
    rest = sq([t for t, s in zip(tensors, sharded) if not s])
    if group is not None:
        part = pd.all_reduce_sum(part, group)
    return torch.sqrt(part + rest)


def _all_reduce_grads(params: Sequence[nn.Parameter], group) -> None:
    """Sum the gradients of ``params`` over ``group``, one flat buffer per
    dtype."""
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = pd.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                 group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01
B1_BF16 = float(torch.tensor(B1, dtype=torch.bfloat16))


class _AdamWBf16Mu:
    """optax's ``adamw(lr, b1, b2, eps, weight_decay, mu_dtype=bf16)``, in
    float32: mu = (1 - b1) g + bf16(bf16(b1) mu), nu = (1 - b2) g^2 + b2 nu,
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p,
    p += -lr u; mu is then stored rounded to bf16, nu in float32."""

    def __init__(self, params: Sequence[nn.Parameter], weight_decay: float):
        self.params = params
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, lr: float, count: int) -> None:
        grads = [p.grad for p in self.params]
        mu = torch._foreach_mul(grads, 1.0 - B1)
        # JAX multiplies the bf16 moment by b1 in bf16: b1 itself rounds to
        # bf16 (0.8984375), and so does the product, before the sum
        torch._foreach_add_(mu, [m.float() for m in
                                 torch._foreach_mul(self.mu, B1_BF16)])
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - B2)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, sq)
        # bias corrections in float32, as optax's 1 - decay ** count
        t = np.float32(count + 1)
        c1 = float(np.float32(1.0) - np.float32(B1) ** t)
        c2 = float(np.float32(1.0) - np.float32(B2) ** t)
        den = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, float(-np.float32(lr)))
        torch._foreach_add_(self.params, upd)
        for dst, src in zip(self.mu, mu):
            dst.copy_(src)

    def state_dict(self) -> dict:
        return {"mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(src)


class ClippedAdamW:
    """optax's clip_by_global_norm then adamw over ``params`` (the first
    moment in bf16 with ``cfg.mu_bf16``) with ``cfg``'s schedule and clip;
    ``step()`` returns the global gradient norm before the clip (a device
    tensor; the shards of a tensor-parallel model, known by their
    ``_tp_layout``, summed over its model group). ``weight_decay`` is the trainer's 0.01 unless given (reflow
    distillation keeps optax's default, 1e-4)."""

    def __init__(self, params: Iterable[nn.Parameter], cfg: TrainConfig, *,
                 weight_decay: float = WEIGHT_DECAY):
        self.params = list(params)
        self.schedule = make_lr_schedule(cfg)
        self.grad_clip = cfg.grad_clip
        self.count = 0
        self.adamw = (_AdamWBf16Mu(self.params, weight_decay) if cfg.mu_bf16
                      else torch.optim.AdamW(self.params, lr=self.schedule(0),
                                             betas=(B1, B2), eps=EPS,
                                             weight_decay=weight_decay))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        layouts = [getattr(p, "_tp_layout", None) for p in self.params]
        group = next((lay.group for lay in layouts if lay is not None), None)
        norm = sharded_global_norm(
            grads, [lay is not None for lay in layouts], group)
        torch._foreach_mul_(grads, torch.where(
            norm < self.grad_clip, 1.0, self.grad_clip / norm))
        lr = self.schedule(self.count)
        if isinstance(self.adamw, _AdamWBf16Mu):
            self.adamw.step(lr, self.count)
        else:
            for group in self.adamw.param_groups:
                group["lr"] = lr
            self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self, fn=None) -> dict:
        """The count and AdamW's state; ``fn(param, moment)`` maps each
        per-parameter moment (gathering shards under a mesh)."""
        state = self.adamw.state_dict()
        if fn is not None:
            state = self._map(state, fn)
        return {"count": self.count, "adamw": state}

    def load_state_dict(self, state: dict, fn=None) -> None:
        self.count = int(state["count"])
        adamw = state["adamw"]
        if fn is not None:
            adamw = self._map(adamw, fn)
        self.adamw.load_state_dict(adamw)

    def _map(self, state: dict, fn) -> dict:
        if isinstance(self.adamw, _AdamWBf16Mu):
            return {k: [fn(p, t) for p, t in zip(self.params, v)]
                    for k, v in state.items()}
        out = dict(state)
        out["state"] = {
            i: {k: (fn(self.params[i], v) if isinstance(v, torch.Tensor)
                    and v.ndim > 0 else v) for k, v in st.items()}
            for i, st in state["state"].items()}
        return out


def make_tx(cfg: TrainConfig, params: Iterable[nn.Parameter]) -> ClippedAdamW:
    return ClippedAdamW(params, cfg)


class EMA:
    """Exponential moving average of a model's parameters (on its device):
    shadow = decay * shadow + (1 - decay) * param after every step."""

    def __init__(self, model: nn.Module, decay: float):
        self.decay = decay
        self.shadow = {name: p.detach().clone()
                       for name, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        names, params = zip(*model.named_parameters())
        shadow = [self.shadow[name] for name in names]
        torch._foreach_mul_(shadow, self.decay)
        torch._foreach_add_(shadow, [p.detach() for p in params],
                            alpha=1.0 - self.decay)

    @torch.no_grad()
    def copy_to(self, model: nn.Module) -> None:
        for name, p in model.named_parameters():
            p.copy_(self.shadow[name])


def _loss(model: CFM, batch: dict, *, generator, draws, midi_loss_weight,
          val: bool = False, times=None, collect_hidden_layer=None,
          params: Optional[dict] = None, psum=None):
    """``model.loss`` on a batch dict; with ``frames`` in it (a V2P batch)
    also its ``midis``, as JAX's ``has_frames``. With ``params`` the model
    runs on those parameters instead of its own (``functional_call``)."""
    has_frames = batch.get("frames") is not None
    kwargs = dict(
        lens=batch["lens"], text_embed=batch["text_embed"],
        context=batch.get("context"), context_mask=batch.get("context_mask"),
        generator=generator, draws=draws, times=times, val=val,
        frames=batch["frames"] if has_frames else None,
        midis=batch.get("midis") if has_frames else None,
        midi_loss_weight=midi_loss_weight,
        collect_hidden_layer=collect_hidden_layer, psum=psum)
    if params is not None:
        return torch.func.functional_call(model, params,
                                          (batch["latents"],), kwargs)
    return model.loss(batch["latents"], **kwargs)


def _micro(batch: dict, i: int, accum: int) -> dict:
    return {k: (v.reshape((accum, -1) + tuple(v.shape[1:]))[i]
                if isinstance(v, torch.Tensor) and v.ndim > 0 else v)
            for k, v in batch.items()}


@torch.no_grad()
def _ref_scores(model: CFM, ref: dict, batch: dict, draws: LossDraws,
                midi_loss_weight: float, psum=None) -> torch.Tensor:
    """The DPO reference's per-sample scores: the loss of ``model`` run on
    the parameters ``ref`` (the EMA shadow) at the policy's ``draws``. The
    model's dropout generator is put back to its state before the call, so
    that the policy's forward draws the same dropout masks, as JAX's shadow
    (a clone of the model's RNG state, advanced once a step like the
    model's) does."""
    gen = model.dropout_generator
    state = gen.get_state() if gen is not None else None
    try:
        out = _loss(model, batch, generator=None, draws=draws,
                    midi_loss_weight=midi_loss_weight, params=ref, psum=psum)
    finally:
        if gen is not None:
            gen.set_state(state)
    return out.per_sample_flow


def _rows(draws: LossDraws, rows) -> LossDraws:
    """This data rank's rows of the global micro-batch's draws (the batch
    draw ``drop_text`` is shared)."""
    return LossDraws(*(x if x.ndim == 0 else rows.shard(x) for x in draws))


def make_train_step(train_cfg: TrainConfig, mesh=None):
    """Build the train step ``step(model, optimizer, batch, *, generator,
    draws=None, ref=None, fcl=None, fcl_opt=None, feature_t=None) ->
    (loss, breakdown, grad_norm)``. The batch dict carries latents
    (b, n, C), lens (b,), text_embed (b, n, dt), context (b, nc, dc) and
    context_mask (b, nc), and for V2P frames (b, t, H, W) in [0, 1] and
    midis (b, n, notes). With ``grad_accum > 1`` the batch splits into
    micro-batches along axis 0 and their gradients are averaged; ``draws``
    (and ``feature_t``) are then one per micro-batch.

    ``TrainConfig.dpo`` and ``TrainConfig.contrastive`` fold the preference
    and FactorCL objectives into the same step, as JAX's:
      * DPO: rows [-2] / [-1] of each micro-batch are the winner / loser
        of a preference pair (``TrainBatcher(dpo=True, micro_batches=
        accum)``); the reference scores come from the model run on
        ``ref`` (the EMA shadow's parameters) at the same draws, without
        autograd, and ``dpo_pair_loss`` at scale ``-dpo_beta`` joins the
        loss;
      * contrastive: the layer-``contrastive_layer`` (audio, CLIP-stream)
        hiddens of rows 2..8 at timestep ``feature_t`` (drawn from
        ``generator`` when None) feed ``fcl``'s CLUB bound and learning
        loss, times ``contrastive_weight``, when the micro-batch has at
        least 8 rows. One backward reaches the CFM (through the hiddens)
        and FactorCL; ``optimizer`` clips and steps the CFM's gradients,
        ``fcl_opt`` FactorCL's.

    With ``mesh`` the batch is this rank's rows (``batch_sharding(mesh)
    .shard(global, micro=grad_accum)``), ``draws`` when given are the
    global micro-batches', and the step runs as the module docstring
    says."""
    accum = max(1, train_cfg.grad_accum)
    use_dpo, use_con = train_cfg.dpo, train_cfg.contrastive
    collect = train_cfg.contrastive_layer if use_con else None
    dgroup, dp, _, mgroup, mp, _ = mesh_axes(mesh)
    rows = batch_sharding(mesh) if mesh is not None else None
    psum = ((lambda t: pd.reduce_from_group(t, dgroup)) if dp > 1
            else None)

    def gather(t):
        return pd.gather_from_group(t, dgroup, 0) if dp > 1 else t

    def train_step(model: CFM, optimizer: ClippedAdamW, batch: dict, *,
                   generator: Optional[torch.Generator] = None,
                   draws: LossDraws | Sequence[LossDraws] | None = None,
                   ref: Optional[dict] = None, fcl=None, fcl_opt=None,
                   feature_t=None):
        b = batch["latents"].shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum "
                             f"{accum}")
        if use_dpo and ref is None:
            raise ValueError("TrainConfig.dpo needs the reference parameters "
                             "(ref=, the EMA shadow)")
        if use_con and (fcl is None or fcl_opt is None):
            raise ValueError("TrainConfig.contrastive needs fcl and fcl_opt")
        optimizer.zero_grad()
        if use_con:
            fcl_opt.zero_grad()
        loss_sum, bk_sum = 0.0, None
        for i in range(accum):
            mb = batch if accum == 1 else _micro(batch, i, accum)
            d = draws if accum == 1 or draws is None else draws[i]
            x1 = mb["latents"]
            rows_global = x1.shape[0] * dp
            if d is None and (use_dpo or dp > 1):
                # one set of draws for the policy and the reference; under
                # a mesh the global micro-batch's
                d = draw_loss_randoms(
                    rows_global, *x1.shape[1:],
                    model.cond_cfg.frac_lengths_mask, generator=generator,
                    device=x1.device)
            if d is not None and dp > 1:
                d = _rows(d, rows)
            ref_per = (gather(_ref_scores(model, ref, mb, d,
                                          train_cfg.midi_loss_weight, psum))
                       if use_dpo else None)
            out = _loss(model, mb, generator=generator, draws=d,
                        midi_loss_weight=train_cfg.midi_loss_weight,
                        collect_hidden_layer=collect, psum=psum)
            total, bk = out.loss, out.breakdown
            if use_con and rows_global >= 8:
                ft = (feature_t if accum == 1 or feature_t is None
                      else feature_t[i])
                fa, fb, labels = sample_contrastive_features(
                    gather(out.hiddens[0]), gather(out.hiddens[1]),
                    model.cfg.num_registers, ft, generator=generator)
                loss_con = fcl(fa, fb, labels) + fcl.learning_loss(
                    fa, fb, labels)
                total = total + train_cfg.contrastive_weight * loss_con
                bk = bk._replace(contrastive=loss_con)
            if use_dpo:
                per = gather(out.per_sample_flow)
                loss_dpo = dpo_pair_loss(per[-2], per[-1], ref_per[-2],
                                         ref_per[-1],
                                         scale=-train_cfg.dpo_beta)
                total = total + loss_dpo
                bk = bk._replace(dpo=loss_dpo)
            (total / accum).backward()
            bk = LossBreakdown(*(x.detach() if isinstance(x, torch.Tensor)
                                 else x for x in bk))
            loss_sum = loss_sum + total.detach()
            bk_sum = bk if bk_sum is None else LossBreakdown(
                *(a + c for a, c in zip(bk_sum, bk)))
        if mesh is not None:
            _sync_grads(optimizer.params, mgroup if mp > 1 else None,
                        dgroup if dp > 1 else None)
        grad_norm = optimizer.step()
        if use_con:
            fcl_opt.step()
        return (loss_sum / accum, LossBreakdown(*(a / accum for a in bk_sum)),
                grad_norm)

    return train_step


@torch.no_grad()
def _sync_grads(params, model_group, data_group) -> None:
    """Sum the partly-used replicated parameters' gradients over the model
    group, then every gradient over the data group (a parameter outside the
    loss gets a zero gradient first, as the optimizer gives it)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if model_group is not None:
        partial = [p for p in params if getattr(p, "_tp_partial", False)]
        if partial:
            _all_reduce_grads(partial, model_group)
    if data_group is not None:
        _all_reduce_grads(params, data_group)


def make_eval_step(train_cfg: TrainConfig | None = None, mesh=None):
    """Deterministic validation forward: times 0.5, the centred span, no
    condition dropout or transformer dropout, no autograd.
    ``step(model, batch, *, generator, draws=None, return_pred=False)``;
    with ``mesh`` the batch is this rank's rows and the loss the global
    batch's."""
    midi_loss_weight = (train_cfg or TrainConfig()).midi_loss_weight
    dgroup, dp = mesh_axes(mesh)[:2]
    psum = ((lambda t: pd.reduce_from_group(t, dgroup)) if dp > 1
            else None)

    @torch.no_grad()
    def eval_step(model: CFM, batch: dict, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[LossDraws] = None, return_pred: bool = False):
        if dp > 1:
            x1 = batch["latents"]
            if draws is None:
                draws = draw_loss_randoms(
                    x1.shape[0] * dp, *x1.shape[1:],
                    model.cond_cfg.frac_lengths_mask, generator=generator,
                    device=x1.device)
            draws = _rows(draws, batch_sharding(mesh))
        out = _loss(model, batch, generator=generator, draws=draws, val=True,
                    times=0.5, midi_loss_weight=midi_loss_weight, psum=psum)
        if return_pred:
            return out.loss, out.breakdown, out.pred_data
        return out.loss, out.breakdown

    return eval_step


class Trainer:
    """Host-side orchestration: train / eval steps, EMA and switch-EMA. The
    loss's random draws come from ``self.generator``, a ``torch.Generator``
    on the model's device seeded from ``seed``; ``last_grad_norm`` holds the
    last step's global gradient norm (before the clip). ``TrainConfig.dpo``
    turns EMA on (the shadow is the DPO reference model);
    ``TrainConfig.contrastive`` builds ``fcl`` (FactorCL over the model's
    audio and CLIP-stream widths, initialised from seed 0 on the model's
    device) and its optimizer ``fcl_opt`` (JAX's ``optax.adamw(lr)``).
    ``mesh`` (``parallel.make_mesh``) shards the model with
    ``parallel.shard_model`` unless it already is, and ``train_step`` then
    takes this rank's rows of the global batch."""

    def __init__(self, model: CFM, train_cfg: TrainConfig | None = None, *,
                 seed: int = 0, mesh=None):
        self.cfg = train_cfg or TrainConfig()
        self.model = model
        self.mesh = mesh
        if mesh is not None and getattr(model, "_tp_mesh", None) is not mesh:
            shard_model(model, mesh)
        self._train_step = make_train_step(self.cfg, mesh)
        self._eval_step = make_eval_step(self.cfg, mesh)
        self.optimizer = make_tx(self.cfg, model.parameters())
        self.ema = (EMA(model, self.cfg.ema_decay)
                    if self.cfg.use_ema or self.cfg.dpo else None)
        self.device = next(model.parameters()).device
        self.fcl = self.fcl_opt = None
        if self.cfg.contrastive:
            with seeded_init(0, self.device):
                self.fcl = FactorCL(model.cfg.dim, model.cfg.dim_text,
                                    device=self.device)
            self.fcl_opt = FactorCLAdamW(self.fcl.parameters(),
                                         self.cfg.learning_rate)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.step = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

    def _on_device(self, batch: dict) -> dict:
        return {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}

    def train_step(self, batch: dict, *, draws=None,
                   feature_t=None) -> tuple:
        """One step; ``draws`` (``LossDraws``, one per micro-batch) and
        ``feature_t`` (FactorCL's timestep) are drawn from ``generator``
        when None."""
        loss, breakdown, self.last_grad_norm = self._train_step(
            self.model, self.optimizer, self._on_device(batch),
            generator=self.generator, draws=draws,
            ref=self.ema.shadow if self.cfg.dpo else None, fcl=self.fcl,
            fcl_opt=self.fcl_opt, feature_t=feature_t)
        if self.ema is not None:
            self.ema.update(self.model)
        self.step += 1
        return loss, breakdown

    def eval_step(self, batch: dict, *, draws=None, return_pred: bool = False,
                  generator: Optional[torch.Generator] = None) -> tuple:
        """The val loss; x0 drawn from ``generator`` (the trainer's when
        None) unless ``draws`` are given."""
        return self._eval_step(self.model, self._on_device(batch),
                               generator=generator or self.generator,
                               draws=draws, return_pred=return_pred)

    def switch_ema(self) -> None:
        """Copy the EMA shadow into the live model ("switch EMA"); the
        optimizer moments are kept."""
        if self.ema is None:
            raise ValueError("switch_ema requires use_ema=True")
        self.ema.copy_to(self.model)

    def state_dict(self) -> dict:
        """The exact training state: the model's parameters and buffers and
        its dropout generator's state, the optimizer's, the EMA shadow,
        FactorCL and its optimizer (which JAX's checkpoint leaves out), the
        step. The tensors are the live ones (no copies); under a mesh the
        shards gathered (every rank of it calls this)."""
        gen = self.model.dropout_generator
        sharded = self.mesh is not None
        params = dict(self.model.named_parameters())
        ema = self.ema.shadow if self.ema is not None else None
        if sharded and ema is not None:
            ema = {k: gather_like(params[k], v) for k, v in ema.items()}
        return {"model": (full_state_dict(self.model) if sharded
                          else self.model.state_dict()),
                "rng": gen.get_state() if gen is not None else None,
                "opt": self.optimizer.state_dict(
                    gather_like if sharded else None),
                "ema": ema,
                "fcl": self.fcl.state_dict() if self.fcl is not None else None,
                "fcl_opt": (self.fcl_opt.state_dict()
                            if self.fcl_opt is not None else None),
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s state (under a mesh, an unsharded state
        is sharded into this rank's parts)."""
        sharded = self.mesh is not None
        params = dict(self.model.named_parameters())
        if sharded:
            load_full_state_dict(self.model, state["model"])
        else:
            self.model.load_state_dict(state["model"])
        if state["rng"] is not None:
            self.model.dropout_generator.set_state(state["rng"])
        self.optimizer.load_state_dict(state["opt"],
                                       shard_like if sharded else None)
        if self.ema is not None and state["ema"] is not None:
            for name, s in self.ema.shadow.items():
                full = state["ema"][name]
                s.copy_(shard_like(params[name], full) if sharded else full)
        if self.fcl is not None and state.get("fcl") is not None:
            self.fcl.load_state_dict(state["fcl"])
            self.fcl_opt.load_state_dict(state["fcl_opt"])
        self.step = int(state["step"])

    def run(self, batches: Iterator[dict], *, num_steps: int,
            log_every: int = 50, callback=None) -> None:
        for i, batch in zip(range(num_steps), batches):
            loss, breakdown = self.train_step(batch)
            if callback is not None and i % log_every == 0:
                callback(self.step, float(loss), breakdown)
