"""Parity of the port's preference and contrastive training
(``v2ap_torch.training.dpo``, ``training.contrastive``, the hidden-layer
tap, DPO and FactorCL folded into ``Trainer``) with the JAX package's, on
the CPU in float32.

Weights go JAX -> port through ``load_jax_params`` (randomised at scale
0.05); dropout is 0 except where a test says; JAX's random draws are
computed from its keys and handed to the port. Tolerances: the pair and
flow losses 1e-6 (they are a few float32 operations); the hiddens 1e-5
relative RMS; FactorCL's losses 1e-5 and its gradients 1e-4 relative RMS;
the train steps' losses 1e-5 relative (FactorCL's term, a difference of
means of O(1) critic scores, also 1e-6 absolute), the updated CFM and EMA
parameters 1e-5 relative RMS (a 2-layer transformer's backward in f32,
summation order differs between XLA and PyTorch). FactorCL's optimizer
steps at a constant lr of 1e-3 from its first step, where Adam's update is
lr g / (|g| + 1e-8), about +-lr: its parameters agree within 1e-5 relative
RMS except where the gradient is near 0 (rounding can flip its sign there),
where they may differ by up to 2 lr, as in tests/test_torch_training.py.
"""

import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from tests.test_torch_models import model_cfgs, rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from tests.test_torch_training import jax_draws, jax_grad_to_port
from v2ap_torch import config as t_config
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.training import contrastive as t_con
from v2ap_torch.training import dpo as t_dpo
from v2ap_torch.training import trainer as t_trainer
from v2ap_torch.utils import convert as t_convert
from v2ap_torch.utils.checkpoint import CheckpointManager
from v2ap_tpu import config as j_config
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.training import contrastive as j_con
from v2ap_tpu.training import dpo as j_dpo
from v2ap_tpu.training import trainer as j_trainer

torch.set_num_threads(2)

N_LAT, NC = 24, 4
REL = 1e-5


def _cfgs(**kw):
    return model_cfgs(depth=2, text_depth=2, **{"dropout": 0.0, **kw})


def _batch(rng, cfg, b):
    """b rows, ragged lens and context mask; the last two rows share their
    conditioning (a preference pair)."""
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    lens = np.full((b,), N_LAT, np.int32)
    lens[1] = N_LAT - 7
    cmask = np.ones((b, NC), bool)
    cmask[0, NC // 2:] = False
    out = dict(latents=r(b, N_LAT, cfg.num_channels), lens=lens,
               text_embed=r(b, N_LAT, cfg.dim_text),
               context=r(b, NC, cfg.dim_context), context_mask=cmask)
    for k in ("text_embed", "context", "context_mask", "lens"):
        out[k][-1] = out[k][-2]
    return out


def _pair(seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(0))
    randomize_jax(jm, seed, scale=0.05)
    tm = t_cfm.CFM(tcfg, t_config.tiny_test().conditioning, device="cpu")
    t_convert.load_jax_params(tm, flatten_jax(jm))
    return jm, tm, jcfg


def _port_layout(tm, flat):
    out = {}
    for key, arr in flat.items():
        name, transform = t_convert._target(tm, key)
        out[name] = np.asarray(transform(np.asarray(arr)))
    return out


def _assert_params(module, flat_j, tol=REL):
    want = _port_layout(module, flat_j)
    for name, p in module.named_parameters():
        assert rel_rms(N(p), want[name]) < tol, name


def _assert_adam_params(module, flat_j, lr):
    """The parameters after Adam's first step at ``lr`` equal JAX's (see
    the module docstring): within 1e-5 relative RMS, except where the
    step's gradient (the port's, left on the parameter) is near 0, where
    rounding can flip its sign and the two may differ by up to 2 lr."""
    want = _port_layout(module, flat_j)
    for name, p in module.named_parameters():
        g = np.abs(N(p.grad))
        # below 1e-6: the critic's output bias, whose gradient cancels in
        # both of FactorCL's losses (rounding noise on either side)
        near0 = (g <= 1e-3 * np.sqrt(np.mean(g ** 2))) | (g < 1e-6)
        got = N(p)
        if (~near0).any():
            assert rel_rms(got[~near0], want[name][~near0]) < REL, name
        assert np.all(np.abs(got - want[name]) <= 2 * lr + 1e-6), name


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: T(v) for k, v in batch.items()}


# ------------------------------------------------------------- pair losses

def test_pair_losses_match_jax():
    rng = np.random.default_rng(30)
    pred, flow = (rng.normal(size=(3, 10, 5)).astype(np.float32)
                  for _ in range(2))
    span = rng.random((3, 10)) > 0.3
    span[2] = False                                  # an empty span
    got = N(t_dpo.per_sample_flow_loss(T(pred), T(flow), T(span)))
    want = np.asarray(j_dpo.per_sample_flow_loss(
        jnp.asarray(pred), jnp.asarray(flow), jnp.asarray(span)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    v = rng.normal(size=(4, 3)).astype(np.float32)
    for scale in (-1.0, -2.5, 1.0):
        np.testing.assert_allclose(
            t_dpo.dpo_pair_loss(*map(T, v), scale=scale).item(),
            float(j_dpo.dpo_pair_loss(*map(jnp.asarray, v), scale=scale)),
            rtol=1e-6)


# --------------------------------------------------------------- the tap

def _tap_inputs(cfg, rng):
    b = 3
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    mask = np.ones((b, N_LAT), bool)
    mask[1, -5:] = False
    return dict(x=r(b, N_LAT, cfg.num_channels), t=r(b) ** 2 % 1,
                mask=mask, text=r(b, N_LAT, cfg.dim_text),
                roll=rng.random((b, N_LAT, cfg.notes)).astype(np.float32),
                ctx=r(b, NC, cfg.dim_context), cmask=np.ones((b, NC), bool))


def _tap_port(tm, a, deterministic=True, layer=1):
    return tm.pred_head(T(a["x"]), None, times=T(a["t"]), mask=T(a["mask"]),
                        text_embed=T(a["text"]), frames_embed=T(a["roll"]),
                        context=T(a["ctx"]), context_mask=T(a["cmask"]),
                        deterministic=deterministic,
                        collect_hidden_layer=layer)


@pytest.mark.parametrize("layer", [1, 2])
def test_hidden_tap_matches_jax(layer):
    """pred_head(collect_hidden_layer=) returns the layer's audio and
    CLIP-stream hiddens, registers included, as JAX's."""
    jm, tm, cfg = _pair(31)
    a = _tap_inputs(cfg, np.random.default_rng(32))
    pred_j, (ah_j, th_j) = nnx.jit(lambda m, *v: m.pred_head(
        v[0], None, times=v[1], mask=v[2], text_embed=v[3], frames_embed=v[4],
        context=v[5], context_mask=v[6], collect_hidden_layer=layer))(
            jm, *(jnp.asarray(a[k]) for k in ("x", "t", "mask", "text", "roll",
                                               "ctx", "cmask")))
    with torch.no_grad():
        pred, (ah, th) = _tap_port(tm, a, layer=layer)
    assert ah.shape == (3, N_LAT + cfg.num_registers, cfg.dim)
    assert th.shape == (3, N_LAT + cfg.num_registers, cfg.dim_text)
    for got, want in ((pred, pred_j), (ah, ah_j), (th, th_j)):
        assert rel_rms(N(got), np.asarray(want)) < REL


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_hidden_tap_under_remat(policy):
    """At dropout 0.1 the tapped hiddens come out of the checkpointed layer
    equal to those without remat, and so do the gradients of a loss on
    them and on the prediction."""
    _, tcfg = _cfgs(dropout=0.1)
    cond = t_config.tiny_test().conditioning
    a = _tap_inputs(tcfg, np.random.default_rng(33))
    rng = np.random.default_rng(34)
    w = [T(rng.normal(size=s).astype(np.float32)) for s in
         ((3, N_LAT, tcfg.num_channels),
          (3, N_LAT + tcfg.num_registers, tcfg.dim),
          (3, N_LAT + tcfg.num_registers, tcfg.dim_text))]
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        torch.manual_seed(0)
        tm = t_cfm.CFM(cfg, cond, device="cpu", dropout_seed=3)
        pred, (ah, th) = _tap_port(tm, a, deterministic=False)
        ((pred * w[0]).sum() + (ah * w[1]).sum() + (th * w[2]).sum()).backward()
        runs.append(([pred, ah, th],
                     {k: p.grad.clone() for k, p in tm.named_parameters()
                      if p.grad is not None}))
    for got, want in zip(runs[1][0], runs[0][0]):
        assert torch.equal(got, want)
    assert runs[1][1].keys() == runs[0][1].keys()
    for k, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], g, rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------- FactorCL

@pytest.fixture(scope="module")
def fcl_pair():
    jf = j_con.FactorCL(16, 12, rngs=nnx.Rngs(3))
    randomize_jax(jf, 35, scale=0.2)
    tf = t_con.FactorCL(16, 12, device="cpu")
    t_convert.load_jax_params(tf, flatten_jax(jf))
    rng = np.random.default_rng(36)
    a = rng.normal(size=(6, 16)).astype(np.float32)
    b = rng.normal(size=(6, 12)).astype(np.float32)
    return jf, tf, a, b, np.arange(6)


@pytest.mark.parametrize("fn", ["club", "learning_loss"])
def test_factorcl_losses_and_grads_match_jax(fcl_pair, fn):
    jf, tf, a, b, labels = fcl_pair

    def jloss(m, a, b):
        f = m if fn == "club" else m.learning_loss
        return f(a, b, jnp.asarray(labels))

    val_j, (g_j, ga_j, gb_j) = jax.value_and_grad(
        lambda st, a, b: jloss(nnx.merge(nnx.graphdef(jf), st), a, b),
        argnums=(0, 1, 2))(nnx.state(jf), jnp.asarray(a), jnp.asarray(b))
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    tf.zero_grad(set_to_none=True)
    f = tf if fn == "club" else tf.learning_loss
    val = f(ta, tb, torch.from_numpy(labels))
    val.backward()
    np.testing.assert_allclose(val.item(), float(val_j), rtol=REL, atol=1e-7)
    assert rel_rms(N(ta.grad), np.asarray(ga_j)) < 1e-4
    assert rel_rms(N(tb.grad), np.asarray(gb_j)) < 1e-4
    gj = jax_grad_to_port(tf, g_j)
    for name, p in tf.named_parameters():
        # CLUB's difference of means cancels the critic's output bias: its
        # gradient is rounding noise (~1e-7) in XLA, exactly 0 here
        assert (rel_rms(N(p.grad), gj[name]) < 1e-4
                or np.abs(N(p.grad) - gj[name]).max() < 1e-6), name


def test_sample_contrastive_features_exact():
    rng = np.random.default_rng(37)
    ah = rng.normal(size=(8, 4 + N_LAT, 16)).astype(np.float32)
    th = rng.normal(size=(8, 4 + N_LAT, 12)).astype(np.float32)
    key = jax.random.key(9)
    want = j_con.sample_contrastive_features(jnp.asarray(ah), jnp.asarray(th),
                                             4, key)
    t = T(np.asarray(jax.random.randint(key, (), 0, N_LAT)))
    got = t_con.sample_contrastive_features(T(ah), T(th), 4, t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    drawn = t_con.sample_contrastive_features(
        T(ah), T(th), 4, generator=torch.Generator().manual_seed(1))
    assert drawn[0].shape == (6, 16) and drawn[1].shape == (6, 12)


def test_factorcl_optimizer_is_optax_adamw_default():
    """FactorCL's optimizer is optax.adamw(lr) with optax's default weight
    decay (1e-4, not the trainer's 0.01): fed the same gradients (one
    parameter without a gradient, which optax still decays), the same
    parameters over three steps."""
    assert t_con.FCL_WEIGHT_DECAY == \
        inspect.signature(optax.adamw).parameters["weight_decay"].default
    assert t_con.FCL_WEIGHT_DECAY != t_trainer.WEIGHT_DECAY
    rng = np.random.default_rng(38)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    tx = optax.adamw(1e-2)
    state = tx.init(params)
    tp = [torch.nn.Parameter(T(p)) for p in params]
    opt = t_con.FactorCLAdamW(tp, 1e-2)
    jp = params
    for step in range(3):
        g = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        if step == 1:
            g[1][:] = 0.0
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        tp[0].grad = T(g[0])
        if step != 1:
            tp[1].grad = T(g[1])
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------------- standalone steps

def test_dpo_train_step_matches_jax():
    jm, tm, cfg = _pair(40)
    jref, tref, _ = _pair(41)
    batch = _batch(np.random.default_rng(42), cfg, 4)
    tc = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=100)
    jopt = nnx.Optimizer(jm, j_trainer.make_tx(j_config.TrainConfig(**tc)),
                         wrt=nnx.Param)
    key = jax.random.key(7)
    loss_j = j_dpo.make_dpo_train_step()(jm, jref, jopt, key, _jbatch(batch))
    _, k_start, k_x0, k_t = jax.random.split(key, 4)
    b = batch["latents"].shape[0]
    draws = t_dpo.DPODraws(
        T(np.asarray(jax.random.uniform(k_start, (b,)))),
        T(np.asarray(jax.random.normal(k_x0, batch["latents"].shape))),
        T(np.asarray(jax.random.uniform(k_t, (b,)))))
    topt = t_trainer.make_tx(t_config.TrainConfig(**tc), tm.parameters())
    loss_t = t_dpo.make_dpo_train_step()(tm, tref, topt, _tbatch(batch),
                                         draws=draws)
    for got, want in zip(loss_t, loss_j):
        np.testing.assert_allclose(got.item(), float(want), rtol=REL)
    assert abs(float(loss_j[2]) - math.log(2)) > 1e-3     # a real reference
    _assert_params(tm, flatten_jax(jm))


def test_contrastive_train_step_matches_jax():
    jm, tm, cfg = _pair(43)
    jf = j_con.FactorCL(cfg.dim, cfg.dim_text, rngs=nnx.Rngs(0))
    tf = t_con.FactorCL(cfg.dim, cfg.dim_text, device="cpu")
    t_convert.load_jax_params(tf, flatten_jax(jf))
    batch = _batch(np.random.default_rng(44), cfg, 8)
    tc = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=100)
    jopt = nnx.Optimizer(jm, j_trainer.make_tx(j_config.TrainConfig(**tc)),
                         wrt=nnx.Param)
    jfopt = nnx.Optimizer(jf, optax.adamw(1e-3), wrt=nnx.Param)
    key = jax.random.key(8)
    loss_j = j_con.make_contrastive_train_step(jf)(jm, jf, jopt, jfopt, key,
                                                   _jbatch(batch))
    k_x0, k_t, k_ts = jax.random.split(key, 3)
    draws = t_con.ContrastiveDraws(
        T(np.asarray(jax.random.normal(k_x0, batch["latents"].shape))),
        T(np.asarray(jax.random.uniform(k_t, (8,)))),
        T(np.asarray(jax.random.randint(k_ts, (), 0, N_LAT))))
    topt = t_trainer.make_tx(t_config.TrainConfig(**tc), tm.parameters())
    tfopt = t_con.FactorCLAdamW(tf.parameters(), 1e-3)
    loss_t = t_con.make_contrastive_train_step(tf)(
        tm, tf, topt, tfopt, _tbatch(batch), draws=draws)
    for got, want in zip(loss_t, loss_j):
        np.testing.assert_allclose(got.item(), float(want), rtol=REL,
                                   atol=1e-6)
    assert loss_t[2].item() != 0.0
    _assert_params(tm, flatten_jax(jm))
    _assert_adam_params(tf, flatten_jax(jf), 1e-3)


# ------------------------------------------------------------- the trainer

@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def dpo_trained(request):
    """One Trainer step with dpo and contrastive on each side from the same
    weights, EMA shadow (set apart from the model, so that the reference
    scores differ) and FactorCL, at JAX's draws; 8 rows a micro-batch (the
    contrastive gate open), the pair in the last two of each."""
    accum = request.param
    jm, tm, cfg = _pair(45)
    kw = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=1000,
              ema_decay=0.9, grad_accum=accum, dpo=True, contrastive=True)
    jt = j_trainer.Trainer(jm, j_config.TrainConfig(**kw))
    tt = t_trainer.Trainer(tm, t_config.TrainConfig(**kw))
    assert jt.ema is not None and tt.ema is not None       # dpo turns EMA on
    randomize_jax(jt.ema.shadow, 46, scale=0.05)
    with torch.no_grad():
        for name, v in _port_layout(tm, flatten_jax(jt.ema.shadow)).items():
            if name in tt.ema.shadow:
                tt.ema.shadow[name].copy_(T(v))
    randomize_jax(jt.fcl, 47, scale=0.05)
    t_convert.load_jax_params(tt.fcl, flatten_jax(jt.fcl))
    rng_np = np.random.default_rng(48)
    parts = [_batch(rng_np, cfg, 8) for _ in range(accum)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    rng = jax.random.key(6)
    subs = [rng] if accum == 1 else [jax.random.fold_in(rng, i)
                                     for i in range(accum)]
    keys = [jax.random.split(s) for s in subs]
    loss_j, bk_j = jt.train_step(rng, _jbatch(batch))
    cond = t_config.tiny_test().conditioning
    draws = [jax_draws(k[0], 8, N_LAT, cfg.num_channels, cond) for k in keys]
    fts = [T(np.asarray(jax.random.randint(k[1], (), 0, N_LAT)))
           for k in keys]
    loss_t, bk_t = tt.train_step(
        _tbatch(batch), draws=draws[0] if accum == 1 else draws,
        feature_t=fts[0] if accum == 1 else fts)
    return dict(jm=jm, tm=tm, jt=jt, tt=tt, loss=(float(loss_j), loss_t.item()),
                bk=(bk_j, bk_t), lr=kw["learning_rate"])


def test_trainer_dpo_contrastive_losses_match_jax(dpo_trained):
    tp = dpo_trained
    np.testing.assert_allclose(tp["loss"][1], tp["loss"][0], rtol=REL)
    bk_j, bk_t = tp["bk"]
    for field in ("flow", "dpo"):
        np.testing.assert_allclose(float(getattr(bk_t, field)),
                                   float(getattr(bk_j, field)), rtol=REL)
    np.testing.assert_allclose(float(bk_t.contrastive),
                               float(bk_j.contrastive), rtol=REL, atol=1e-6)
    assert abs(float(bk_t.dpo) - math.log(2)) > 1e-3
    assert float(bk_t.contrastive) != 0.0


def test_trainer_dpo_contrastive_updates_match_jax(dpo_trained):
    """The updated CFM, FactorCL and EMA shadow equal JAX's."""
    tp = dpo_trained
    _assert_params(tp["tm"], flatten_jax(tp["jm"]))
    _assert_adam_params(tp["tt"].fcl, flatten_jax(tp["jt"].fcl), tp["lr"])
    shadow_j = _port_layout(tp["tm"], flatten_jax(tp["jt"].ema.shadow))
    for name, s in tp["tt"].ema.shadow.items():
        assert rel_rms(N(s), shadow_j[name]) < REL, name


def test_first_dpo_step_is_ln2_at_dropout():
    """At dropout 0.1 the first step's DPO term is ln 2 in both packages:
    the reference (the EMA shadow, equal to the model at step 1) draws the
    policy's dropout masks, in JAX from a copy of the model's RNG state, in
    the port from the model's generator put back after the reference
    forward."""
    jcfg, tcfg = _cfgs(dropout=0.1)
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(0))
    tm = t_cfm.CFM(tcfg, t_config.tiny_test().conditioning, device="cpu")
    kw = dict(learning_rate=1e-3, warmup_steps=2, dpo=True)
    batch = _batch(np.random.default_rng(49), jcfg, 4)
    _, bk_j = j_trainer.Trainer(jm, j_config.TrainConfig(**kw)).train_step(
        jax.random.key(0), _jbatch(batch))
    tt = t_trainer.Trainer(tm, t_config.TrainConfig(**kw))
    _, bk_t = tt.train_step(_tbatch(batch))
    assert abs(float(bk_j.dpo) - math.log(2)) < 1e-6
    assert abs(float(bk_t.dpo) - math.log(2)) < 1e-6
    _, bk_t = tt.train_step(_tbatch(batch))
    assert abs(float(bk_t.dpo) - math.log(2)) > 1e-6


def test_trainer_resumes_exactly_with_factorcl(tmp_path):
    """FactorCL and its optimizer ride in Trainer.state_dict: a trainer
    restored from a checkpoint after two steps continues bit-equal."""
    _, tcfg = _cfgs(dropout=0.1)
    cond = t_config.tiny_test().conditioning
    kw = dict(learning_rate=1e-3, warmup_steps=2, dpo=True, contrastive=True)
    batch = _tbatch(_batch(np.random.default_rng(50), tcfg, 8))

    def trainer():
        torch.manual_seed(0)
        return t_trainer.Trainer(t_cfm.CFM(tcfg, cond, device="cpu"),
                                 t_config.TrainConfig(**kw), seed=4)

    a = trainer()
    for _ in range(2):
        a.train_step(batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(a.step, a)
    b = trainer()
    assert mgr.restore(b) == 2
    b.generator.set_state(a.generator.get_state())
    (la, ba), (lb, bb) = a.train_step(batch), b.train_step(batch)
    assert la.item() == lb.item() and float(ba.dpo) == float(bb.dpo)
    assert float(ba.contrastive) == float(bb.contrastive) != 0.0
    for x, y in zip(a.fcl.parameters(), b.fcl.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)
