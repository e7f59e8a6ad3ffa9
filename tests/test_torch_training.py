"""Parity of the port's V2A training path (``CFM.loss``, the masks, dropout,
``v2ap_torch.training``) with the JAX package's, on the CPU in float32.

Weights go JAX -> port through ``load_jax_params`` (randomised so that the
zero-initialised projections are exercised); dropout is 0 on both sides.
The loss's seven random draws are computed from the JAX key exactly as
``v2ap_tpu.models.cfm.CFM.loss`` draws them and handed to the port.

Tolerances: the loss and ``per_sample_flow`` rtol 1e-5; gradients 1e-4
relative RMS per parameter (a backward pass through a 4-layer transformer in
f32, summation order differs between XLA and PyTorch); the optimizer fed
identical gradients 1e-6 absolute on parameters of scale ~0.1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from tests.test_torch_models import model_cfgs, rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch import config as t_config
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.ops import layers as t_layers
from v2ap_torch.ops import sampling as t_sampling
from v2ap_torch.training import trainer as t_trainer
from v2ap_torch.utils import convert as t_convert
from v2ap_tpu import config as j_config
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.ops import sampling as j_sampling
from v2ap_tpu.training import trainer as j_trainer

torch.set_num_threads(2)

GRAD_REL_RMS = 1e-4
B, N_LAT, NC = 2, 24, 4


# ------------------------------------------------------------------ config

def test_train_config_matches_jax():
    assert dataclasses.asdict(t_config.TrainConfig()) == \
        dataclasses.asdict(j_config.TrainConfig())
    assert dataclasses.asdict(t_config.DataConfig()) == \
        dataclasses.asdict(j_config.DataConfig())


# ------------------------------------------------------------ masks, dropout

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_masks_identical(seed):
    """lens_to_mask and mask_from_frac_lengths, int32 truncation of
    frac * lens and max_start * rand included, are identical."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 50, size=7).astype(np.int32)
    frac = rng.uniform(0.7, 1.0, size=7).astype(np.float32)
    start = rng.random(7).astype(np.float32)
    start[0] = 0.999999                         # truncation edge
    np.testing.assert_array_equal(
        N(t_sampling.lens_to_mask(T(lens), 50)),
        np.asarray(j_sampling.lens_to_mask(jnp.asarray(lens), 50)))
    np.testing.assert_array_equal(
        N(t_sampling.mask_from_frac_lengths(T(lens), T(frac), 50, T(start))),
        np.asarray(j_sampling.mask_from_frac_lengths(
            jnp.asarray(lens), jnp.asarray(frac), 50, jnp.asarray(start))))


def test_dropout_keeps_and_scales_like_nnx():
    """Dropout(p) keeps ~(1-p) of the values, scales them by 1/(1-p), zeros
    the rest; the same generator seed gives the same mask; deterministic
    (or p = 0) is the identity."""
    x = torch.ones(200, 500)
    drop = t_layers.Dropout(0.1)
    drop.generator = torch.Generator().manual_seed(3)
    a = drop(x, deterministic=False)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    np.testing.assert_allclose(N(a[kept]), 1 / 0.9, rtol=1e-6)
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x, deterministic=False), a)
    drop.generator = torch.Generator().manual_seed(4)
    assert not torch.equal(drop(x, deterministic=False), a)
    assert drop(x) is x
    assert t_layers.Dropout(0.0)(x, deterministic=False) is x


def test_model_dropout_is_seeded_and_off_in_val():
    """The CFM's dropouts share one seeded generator: two models with the
    same dropout seed give the same training loss, and the val loss does not
    depend on it."""
    _, tcfg = model_cfgs(depth=2, text_depth=2)
    cond = t_config.tiny_test().conditioning
    losses = {}
    for key, seed in (("a", 5), ("b", 5), ("c", 6)):
        torch.manual_seed(0)
        m = t_cfm.CFM(tcfg, cond, device="cpu", dropout_seed=seed)
        batch = _batch(np.random.default_rng(0), tcfg)
        draws = t_cfm.draw_loss_randoms(
            B, N_LAT, tcfg.num_channels, cond.frac_lengths_mask,
            generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            train = _port_loss(m, batch, draws=draws).loss
            val = _port_loss(m, batch, draws=draws, val=True).loss
        losses[key] = (train.item(), val.item())
    assert losses["a"] == losses["b"]
    assert losses["a"][0] != losses["c"][0]
    assert losses["a"][1] == losses["c"][1]


# ------------------------------------------------------------- CFM.loss

def _batch(rng, cfg):
    """A ragged batch: lens (n, n-7), context mask with row 1 half masked
    (no row fully masked)."""
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(latents=r(B, N_LAT, cfg.num_channels),
                lens=np.array([N_LAT, N_LAT - 7], np.int32),
                text_embed=r(B, N_LAT, cfg.dim_text),
                context=r(B, NC, cfg.dim_context),
                context_mask=np.array([[True] * NC,
                                       [True] * (NC // 2) + [False] * (NC // 2)]))


def _port_loss(tm, batch, **kw):
    return tm.loss(T(batch["latents"]), lens=T(batch["lens"]),
                   text_embed=T(batch["text_embed"]),
                   context=T(batch["context"]),
                   context_mask=T(batch["context_mask"]), **kw)


def jax_draws(key, b, n, c, cond) -> t_cfm.LossDraws:
    """The seven values ``v2ap_tpu`` CFM.loss draws from ``key``."""
    ks = jax.random.split(key, 7)
    lo, hi = cond.frac_lengths_mask
    u = jax.random.uniform
    vals = (u(ks[0], (b,), minval=lo, maxval=hi), u(ks[1], (b,)),
            jax.random.normal(ks[2], (b, n, c), jnp.float32),
            u(ks[3], (b,), jnp.float32), u(ks[4], (b,)), u(ks[5], ()),
            u(ks[6], (b,)))
    return t_cfm.LossDraws(*(T(np.asarray(v)) for v in vals))


def jax_grad_to_port(tm, grads) -> dict:
    """A JAX gradient State, laid out as the port's parameters."""
    out = {}
    for path, var in nnx.to_flat_state(grads):
        key = ".".join(map(str, path))
        name, transform = t_convert._target(tm, key)
        out[name] = np.asarray(transform(np.asarray(var[...])))
    return out


CONDS = {
    "v2a": {},                                     # V2A: no audio cond
    "infill": dict(audiocond_drop_prob=0.5, cond_drop_prob=0.5,
                   prompt_drop_prob=0.5),
}


@pytest.fixture(scope="module", params=sorted(CONDS))
def loss_pair(request):
    jcfg, tcfg = model_cfgs(dropout=0.0)
    jcond = dataclasses.replace(j_config.tiny_test().conditioning,
                                **CONDS[request.param])
    tcond = dataclasses.replace(t_config.tiny_test().conditioning,
                                **CONDS[request.param])
    jm = j_cfm.CFM(jcfg, jcond, with_video2roll=False, rngs=nnx.Rngs(0))
    randomize_jax(jm, 11, scale=0.05)
    tm = t_cfm.CFM(tcfg, tcond, device="cpu")
    t_convert.load_jax_params(tm, flatten_jax(jm))
    return request.param, jm, tm, jcfg, jcond


_VG_PROGRAMS: dict = {}


def _jax_value_and_grad(jm, batch, **kw):
    """JAX's loss (with per_sample_flow and pred_flow) and gradient at
    ``batch``: one compiled program per set of non-array arguments, the
    batch and the array arguments passed in, so that equal shapes reuse
    it."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static = tuple(sorted((k, v) for k, v in kw.items() if k not in arrays))
    run = _VG_PROGRAMS.get(static)
    if run is None:
        @nnx.jit
        def run(m, b, arrays):
            def f(m):
                out = m.loss(b["latents"], lens=b["lens"],
                             text_embed=b["text_embed"],
                             context=b["context"],
                             context_mask=b["context_mask"],
                             **arrays, **dict(static))
                return out.loss, (out.per_sample_flow, out.pred_flow)
            return nnx.value_and_grad(f, has_aux=True)(m)
        _VG_PROGRAMS[static] = run
    return run(jm, {k: jnp.asarray(v) for k, v in batch.items()}, arrays)


def _check_loss_and_grads(tm, ref, out):
    (loss_j, (per_j, pred_j)), grads_j = ref
    np.testing.assert_allclose(out.loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(N(out.per_sample_flow), np.asarray(per_j),
                               rtol=1e-5, atol=1e-7)
    assert rel_rms(N(out.pred_flow), pred_j) < GRAD_REL_RMS
    gj = jax_grad_to_port(tm, grads_j)
    params = dict(tm.named_parameters())
    assert set(gj) == set(params)
    for name, g in gj.items():
        p = params[name].grad
        if not np.any(g):
            # a parameter outside the loss (V2A: no audio cond) or with an
            # exactly zero gradient (the zero roll's projection weight)
            assert p is None or not torch.any(p), name
            continue
        assert rel_rms(N(p), g) < GRAD_REL_RMS, name


def test_cfm_loss_val_matches_jax(loss_pair):
    """val=True with a given x0 and times 0.5: the centred span, no
    condition dropout."""
    _, jm, tm, cfg, _ = loss_pair
    rng = np.random.default_rng(12)
    batch = _batch(rng, cfg)
    x0 = rng.normal(size=(B, N_LAT, cfg.num_channels)).astype(np.float32)
    ref = _jax_value_and_grad(jm, batch, rng=jax.random.key(0),
                              x0=jnp.asarray(x0), times=0.5, val=True)
    tm.zero_grad(set_to_none=True)
    out = _port_loss(tm, batch, x0=T(x0), times=0.5, val=True,
                     generator=torch.Generator().manual_seed(0))
    out.loss.backward()
    _check_loss_and_grads(tm, ref, out)


def test_cfm_loss_train_matches_jax(loss_pair):
    """Train mode with JAX's seven draws handed in, ragged lens and a
    ragged context mask."""
    kind, jm, tm, cfg, cond = loss_pair
    batch = _batch(np.random.default_rng(13), cfg)
    key = jax.random.key(21)
    ref = _jax_value_and_grad(jm, batch, rng=key)
    draws = jax_draws(key, B, N_LAT, cfg.num_channels, cond)
    if kind == "infill":     # the seed exercises the condition dropouts
        assert (draws.drop_prompt < 0.5).any() and (draws.drop_audio < 0.5).any()
    tm.zero_grad(set_to_none=True)
    out = _port_loss(tm, batch, draws=draws)
    out.loss.backward()
    _check_loss_and_grads(tm, ref, out)


# ----------------------------------------------------------------- trainer

def test_lr_schedule_matches_optax():
    cfg = t_config.TrainConfig(learning_rate=1e-3, warmup_steps=5,
                               decay_steps=20)
    ours = t_trainer.make_lr_schedule(cfg)
    ref = j_trainer.make_lr_schedule(j_config.TrainConfig(
        learning_rate=1e-3, warmup_steps=5, decay_steps=20))
    for step in (0, 1, 4, 5, 6, 24, 25, 40):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    assert ours(0) == pytest.approx(1e-5, rel=1e-5)     # step 0: 0.01 lr


def test_optimizer_matches_optax_chain():
    """Fed identical gradients, the port's clip + AdamW equals optax's
    chain over 3 steps: warmup lr, one step above the clip norm, two
    below, weight decay on a parameter with a zero gradient."""
    rng = np.random.default_rng(14)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * scale
              for s in shapes] for scale in (2.0, 0.05, 0.1)]
    grads[1][2][:] = 0.0
    jcfg = j_config.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                decay_steps=10)
    tx = j_trainer.make_tx(jcfg)
    state = tx.init(params)
    tp = [torch.nn.Parameter(T(p)) for p in params]
    opt = t_trainer.make_tx(t_config.TrainConfig(
        learning_rate=1e-2, warmup_steps=2, decay_steps=10), tp)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, gi in zip(tp, g):
            p.grad = T(gi)
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-6)


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def trained_pair(request):
    """One Trainer.train_step on each side (lr 1e-3, warmup 2, EMA 0.9,
    ``grad_accum`` 1 or 2 micro-batches of B rows) from the same weights
    and draws; the JAX loss and gradient at those draws, averaged over the
    micro-batches."""
    accum = request.param
    jcfg, tcfg = model_cfgs(dropout=0.0)
    cond = t_config.tiny_test().conditioning
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(0))
    randomize_jax(jm, 15, scale=0.05)
    tm = t_cfm.CFM(tcfg, cond, device="cpu")
    t_convert.load_jax_params(tm, flatten_jax(jm))
    before = {k: np.array(v) for k, v in flatten_jax(jm).items()}
    kw = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=1000,
              use_ema=True, ema_decay=0.9, grad_accum=accum)
    rng_np = np.random.default_rng(16)
    parts = [_batch(rng_np, jcfg) for _ in range(accum)]
    batch = {k: np.concatenate([part[k] for part in parts]) for k in parts[0]}
    rng = jax.random.key(5)
    # the key each micro-batch's loss draws from in JAX's make_train_step
    keys = ([jax.random.split(rng)[0]] if accum == 1 else
            [jax.random.split(jax.random.fold_in(rng, i))[0]
             for i in range(accum)])
    refs = [_jax_value_and_grad(jm, part, rng=k) for part, k in zip(parts, keys)]
    ref_loss = float(np.mean([float(r[0][0]) for r in refs]))
    ref_grads = jax.tree.map(lambda *g: sum(g) / accum, *(r[1] for r in refs))
    jt = j_trainer.Trainer(jm, j_config.TrainConfig(**kw))
    loss_j, _ = jt.train_step(rng, {k: jnp.asarray(v) for k, v in batch.items()})
    tt = t_trainer.Trainer(tm, t_config.TrainConfig(**kw))
    draws = [jax_draws(k, B, N_LAT, jcfg.num_channels, cond) for k in keys]
    loss_t, _ = tt.train_step({k: T(v) for k, v in batch.items()},
                              draws=draws[0] if accum == 1 else draws)
    return dict(jm=jm, tm=tm, jt=jt, tt=tt, ref_loss=ref_loss,
                ref_grads=ref_grads, before=before,
                loss=(float(loss_j), loss_t.item()), lr=1e-3 * 0.01)


def test_train_step_loss_and_clipped_grads_match_jax(trained_pair):
    """The step's loss and clipped gradient equal JAX's; with grad_accum=2
    they are the means over the two micro-batches."""
    tp = trained_pair
    np.testing.assert_allclose(tp["loss"][1], tp["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(tp["loss"][0], tp["ref_loss"], rtol=1e-6)
    gj = jax_grad_to_port(tp["tm"], tp["ref_grads"])
    norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in gj.values())))
    np.testing.assert_allclose(tp["tt"].last_grad_norm.item(), norm,
                               rtol=1e-4)
    clip = min(1.0, 1.0 / norm)
    for name, p in tp["tm"].named_parameters():
        if np.any(gj[name]):
            assert rel_rms(N(p.grad), gj[name] * clip) < GRAD_REL_RMS, name


def _port_layout(tm, flat):
    out = {}
    for key, arr in flat.items():
        name, transform = t_convert._target(tm, key)
        out[name] = np.asarray(transform(np.asarray(arr)))
    return out


def test_train_step_updated_params_match_jax(trained_pair):
    """Updated parameters agree to 1e-6, except where the gradient is near
    0: Adam's first update is +-lr * g / |g|, so a gradient at rounding
    level can flip sign between the two frameworks and move the parameter
    by up to 2 lr there (lr 1e-5 at step 0 of the warmup)."""
    tp = trained_pair
    tm, lr = tp["tm"], tp["lr"]
    gj = jax_grad_to_port(tm, tp["ref_grads"])
    after_j = _port_layout(tm, flatten_jax(tp["jm"]))
    before = _port_layout(tm, tp["before"])
    moved = 0
    for name, p in tm.named_parameters():
        g = np.abs(gj[name])
        near0 = g <= 1e-3 * np.sqrt(np.mean(g ** 2))
        tol = np.where(near0, 2 * lr + 1e-6, 1e-6)
        err = np.abs(N(p) - after_j[name])
        assert np.all(err <= tol), (name, float(err.max()))
        moved += int(np.any(N(p) != before[name]))
    assert moved == len(list(tm.parameters()))


def test_ema_and_switch_ema_match_jax(trained_pair):
    """EMA after one step equals JAX's shadow; switch_ema copies it into
    the model on both sides."""
    tp = trained_pair
    tm, tt, jt = tp["tm"], tp["tt"], tp["jt"]
    shadow_j = _port_layout(tm, flatten_jax(jt.ema.shadow))
    for name, s in tt.ema.shadow.items():
        np.testing.assert_allclose(N(s), shadow_j[name], atol=1e-6)
    jt.switch_ema()
    tt.switch_ema()
    model_j = _port_layout(tm, flatten_jax(tp["jm"]))
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(N(p), N(tt.ema.shadow[name]))
        np.testing.assert_allclose(N(p), model_j[name], atol=1e-6)


def test_eval_step_matches_jax():
    """Trainer.eval_step(return_pred=True) equals JAX's Trainer.eval_step
    at dropout 0.1 and condition-drop probabilities 0.5: the val path must
    switch both dropouts off, fix times at 0.5 and the span at its centre,
    and draw only x0 (from the key's third split, as JAX does). Loss and
    breakdown rtol 1e-5, pred_data rel-RMS 1e-4; no autograd graph."""
    jcfg, tcfg = model_cfgs(dropout=0.1)
    jcond, tcond = (dataclasses.replace(mod.tiny_test().conditioning,
                                        **CONDS["infill"])
                    for mod in (j_config, t_config))
    jm = j_cfm.CFM(jcfg, jcond, with_video2roll=False, rngs=nnx.Rngs(0))
    randomize_jax(jm, 18, scale=0.05)
    tm = t_cfm.CFM(tcfg, tcond, device="cpu")
    t_convert.load_jax_params(tm, flatten_jax(jm))
    batch = _batch(np.random.default_rng(19), jcfg)
    key = jax.random.key(23)
    loss_j, bk_j, pred_j = j_trainer.Trainer(jm).eval_step(
        key, {k: jnp.asarray(v) for k, v in batch.items()}, return_pred=True)
    tt = t_trainer.Trainer(tm)
    draws = jax_draws(key, B, N_LAT, jcfg.num_channels, jcond)
    loss_t, bk_t, pred_t = tt.eval_step({k: T(v) for k, v in batch.items()},
                                        draws=draws, return_pred=True)
    assert not loss_t.requires_grad
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for a, b in zip(bk_t, bk_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-7)
    assert pred_t.shape == (B, N_LAT, jcfg.num_channels)
    assert rel_rms(N(pred_t), np.asarray(pred_j)) < GRAD_REL_RMS
    loss2, bk2 = tt.eval_step({k: T(v) for k, v in batch.items()},
                              draws=draws)
    assert loss2.item() == loss_t.item() and len(bk2) == len(bk_t)


def test_trainer_run_steps_and_calls_back():
    """Trainer.run takes ``num_steps`` steps from the batch iterator (or
    fewer, if it ends first), draws the loss's values and the dropout masks
    from seeded generators, and calls back every ``log_every`` steps with
    the step count and the loss: two runs from the same weights and seeds
    log the same losses."""
    _, tcfg = model_cfgs(dropout=0.1, depth=2, text_depth=2)
    cond = t_config.tiny_test().conditioning
    batch = {k: T(v) for k, v in _batch(np.random.default_rng(20),
                                         tcfg).items()}
    cfg = t_config.TrainConfig(learning_rate=1e-3, warmup_steps=2,
                               use_ema=True)
    logs = []
    for _ in range(2):
        torch.manual_seed(0)
        tm = t_cfm.CFM(tcfg, cond, device="cpu")
        start = [p.detach().clone() for p in tm.parameters()]
        tt = t_trainer.Trainer(tm, cfg, seed=3)
        seen = []
        tt.run(iter([batch] * 5), num_steps=3, log_every=2,
               callback=lambda step, loss, bk: seen.append((step, loss)))
        assert tt.step == 3 and [s for s, _ in seen] == [1, 3]
        assert np.isfinite([x for _, x in seen]).all()
        assert any(not torch.equal(a, p) for a, p in zip(start,
                                                         tm.parameters()))
        logs.append(seen)
    assert logs[0] == logs[1]
    tt.run(iter([batch]), num_steps=3)
    assert tt.step == 4


def test_unported_options_raise():
    """Every training option is ported and builds: DPO and FactorCL
    (tests/test_torch_preference.py), the bf16 first moment and remat
    (tests/test_torch_training_v2p.py). A DPO step without the reference
    parameters, or a FactorCL step without FactorCL, raises."""
    cfg = t_config.TrainConfig(dpo=True, contrastive=True, grad_accum=2)
    step = t_trainer.make_train_step(cfg)
    t_trainer.make_tx(t_config.TrainConfig(mu_bf16=True), [])
    _, tcfg = model_cfgs(remat=True)
    model = t_cfm.CFM(tcfg, device="cpu")
    assert model.transformer.cfg.remat
    trainer = t_trainer.Trainer(model, cfg)
    assert trainer.ema is not None and trainer.fcl is not None
    batch = {k: T(v) for k, v in _batch(np.random.default_rng(21),
                                         tcfg).items()}
    with pytest.raises(ValueError, match="reference"):
        step(model, trainer.optimizer, batch, fcl=trainer.fcl,
             fcl_opt=trainer.fcl_opt)
    with pytest.raises(ValueError, match="fcl"):
        step(model, trainer.optimizer, batch, ref=trainer.ema.shadow)


def test_trainer_refuses_missing_cuda():
    """The port's entry points default to CUDA: a trainer's model built
    without a device raises on a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = model_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_trainer.Trainer(t_cfm.CFM(tcfg))
