"""Parity of the port's V2P training path with the JAX package's, on the
CPU in float32: ``CFM.loss`` with keyboard frames (the MIDI loss through
Video2Roll, the roll metrics), ``Trainer.train_step`` on V2P batches, the
bf16 first moment (``TrainConfig.mu_bf16``) and remat
(``ModelConfig.remat``, policies "full" and "dots").

Weights go JAX -> port through ``load_jax_params`` (every parameter and
BatchNorm statistic redrawn); the loss's seven draws are JAX's, handed to
the port; dropout is 0 against JAX, 0.1 for remat against no remat in the
port. Frames are real 5 x 100 x 900 strip windows.

Tolerances: losses and the roll metrics rtol 1e-5; gradients 1e-4
relative RMS per parameter (as the V2A tests), 2e-3 for Video2Roll's
(twenty f32 convolutions deep; a BatchNorm scale's gradient sums
dy * x_hat over every strip pixel, with cancellation, in another
summation order: read up to 5.4e-4); updated parameters 1e-6
(2 lr where a gradient is at rounding level, as the V2A tests); the bf16
optimizer 1e-6 on parameters, its stored bf16 moment equal to optax's, the
second moment 1e-6 relative (XLA may fuse its multiply-add); remat against
no remat in the port at dropout 0.1: each gradient within 1e-6 of its
scale, or, with Video2Roll in several recomputed chunks (whose
convolutions may block differently), the loss 1e-6 and the gradients
1e-4 relative.
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
from tests.test_torch_training import GRAD_REL_RMS, jax_draws, \
    jax_grad_to_port
from tests.test_torch_video2roll import randomize_params_and_stats
from v2ap_torch import config as t_config
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.training import trainer as t_trainer
from v2ap_torch.utils import convert as t_convert
from v2ap_tpu import config as j_config
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.training import trainer as j_trainer

torch.set_num_threads(2)

B, N_LAT, NC = 2, 12, 4
ROWS = N_LAT // 3 + 1             # strip rows at the roll rate
SMALL = dict(depth=2, text_depth=2, dropout=0.0)
V2R_GRAD_REL_RMS = 2e-3


def _batch(rng, cfg):
    """A ragged V2P batch: lens (n, n - 4), half a context masked in row 1,
    strips in [0, 1] and a binary ground-truth roll."""
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(latents=r(B, N_LAT, cfg.num_channels),
                lens=np.array([N_LAT, N_LAT - 4], np.int32),
                text_embed=r(B, N_LAT, cfg.dim_text),
                context=r(B, NC, cfg.dim_context),
                context_mask=np.array([[True] * NC,
                                       [True] * (NC // 2) + [False] * (NC // 2)]),
                frames=rng.random((B, ROWS, 100, 900)).astype(np.float32),
                midis=(rng.random((B, N_LAT, cfg.notes)) > 0.7
                       ).astype(np.float32))


def _pair(seed, **model_kw):
    """A tiny JAX CFM with Video2Roll, every parameter redrawn (Video2Roll's
    BatchNorm statistics too), and its port."""
    jcfg, tcfg = model_cfgs(**{**SMALL, **model_kw})
    cond = t_config.tiny_test().conditioning
    jm = j_cfm.CFM(jcfg, with_video2roll=True, rngs=nnx.Rngs(seed))
    randomize_jax(jm, seed, scale=0.05)       # as the V2A tests
    randomize_params_and_stats(jm.video2roll, seed + 1)
    tm = t_cfm.CFM(tcfg, cond, with_video2roll=True, device="cpu")
    t_convert.load_jax_params(tm, flatten_jax(jm))
    return jm, tm, jcfg, cond


def _jax_loss_kw(batch):
    return dict(lens=jnp.asarray(batch["lens"]),
                text_embed=jnp.asarray(batch["text_embed"]),
                context=jnp.asarray(batch["context"]),
                context_mask=jnp.asarray(batch["context_mask"]),
                frames=jnp.asarray(batch["frames"]),
                midis=jnp.asarray(batch["midis"]))


_VG_PROGRAMS: dict = {}


def _jax_value_and_grad(jm, batch, **kw):
    """JAX's loss (with its breakdown) and gradient at ``batch``: one
    compiled program per set of non-array arguments, the batch and the
    array arguments passed in, so that equal shapes reuse it."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static = tuple(sorted((k, v) for k, v in kw.items() if k not in arrays))
    run = _VG_PROGRAMS.get(static)
    if run is None:
        @nnx.jit
        def run(m, b, arrays):
            def f(m):
                out = m.loss(b["latents"], **{k: b[k] for k in b
                                              if k != "latents"},
                             **arrays, **dict(static))
                return out.loss, out.breakdown
            return nnx.value_and_grad(f, has_aux=True)(m)
        _VG_PROGRAMS[static] = run
    return run(jm, {k: v for k, v in _jax_loss_kw(batch).items()}
               | {"latents": jnp.asarray(batch["latents"])}, arrays)


def _port_loss(tm, batch, **kw):
    return tm.loss(T(batch["latents"]), lens=T(batch["lens"]),
                   text_embed=T(batch["text_embed"]),
                   context=T(batch["context"]),
                   context_mask=T(batch["context_mask"]),
                   frames=T(batch["frames"]), midis=T(batch["midis"]), **kw)


def _check_grads(tm, grads_j):
    gj = jax_grad_to_port(tm, grads_j)
    params = dict(tm.named_parameters())
    assert set(gj) == set(params)
    v2r = 0
    for name, g in gj.items():
        p = params[name].grad
        if not np.any(g):
            assert p is None or not torch.any(p), name
            continue
        in_v2r = name.startswith("video2roll.")
        tol = V2R_GRAD_REL_RMS if in_v2r else GRAD_REL_RMS
        assert rel_rms(N(p), g) < tol, name
        v2r += in_v2r
    assert v2r > 20                         # the MIDI loss trains the net


@pytest.fixture(scope="module")
def v2p_pair():
    return _pair(31)


# ------------------------------------------------------------- CFM.loss

@pytest.mark.parametrize("mode", ["train", "val", "gt"])
def test_v2p_loss_matches_jax(v2p_pair, mode):
    """The total, flow and MIDI losses, precision / recall / F1 / accuracy
    and every gradient (Video2Roll's included), with JAX's draws handed in
    (train), at times 0.5 with x0 given (val), and with the ground truth
    fed to the frames stream (``use_midi_gt``) at ``midi_loss_weight`` 3."""
    jm, tm, cfg, cond = v2p_pair
    batch = _batch(np.random.default_rng(32), cfg)
    key = jax.random.key(33)
    kw_j, kw_t = {}, {}
    if mode == "val":
        x0 = np.random.default_rng(34).normal(
            size=(B, N_LAT, cfg.num_channels)).astype(np.float32)
        kw_j = dict(x0=jnp.asarray(x0), times=0.5, val=True)
        kw_t = dict(x0=T(x0), times=0.5, val=True,
                    generator=torch.Generator().manual_seed(0))
    else:
        kw_t = dict(draws=jax_draws(key, B, N_LAT, cfg.num_channels, cond))
    if mode == "gt":
        kw_j.update(use_midi_gt=True, midi_loss_weight=3.0)
        kw_t.update(use_midi_gt=True, midi_loss_weight=3.0)
    (loss_j, bk_j), grads_j = _jax_value_and_grad(jm, batch, rng=key, **kw_j)
    tm.zero_grad(set_to_none=True)
    out = _port_loss(tm, batch, **kw_t)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(loss_j), rtol=1e-5)
    for a, b in zip(out.breakdown[:6], bk_j[:6]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-7)
    assert float(bk_j.midi) > 0 and 0 < float(bk_j.recall) < 1
    _check_grads(tm, grads_j)


def test_frozen_video_encoder_feeds_the_ground_truth(v2p_pair):
    """``train_video_encoder=False``: the roll stream takes the ground
    truth, no MIDI loss, no metrics, no Video2Roll gradient; as JAX."""
    jm, tm, cfg, cond = v2p_pair
    batch = _batch(np.random.default_rng(35), cfg)
    key = jax.random.key(36)
    (loss_j, bk_j), _ = _jax_value_and_grad(jm, batch, rng=key,
                                            train_video_encoder=False)
    tm.zero_grad(set_to_none=True)
    out = _port_loss(tm, batch, train_video_encoder=False,
                     draws=jax_draws(key, B, N_LAT, cfg.num_channels, cond))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(loss_j), rtol=1e-5)
    assert all(float(x) == 0 for x in out.breakdown[1:6])
    assert all(p.grad is None for p in tm.video2roll.parameters())


@pytest.mark.parametrize("case", ["random", "perfect", "empty", "masked"])
def test_roll_metrics_match_jax(case):
    """3-frame pooling, thresholds 0.4 (prediction) / 0.5 (ground truth),
    pooled mask mean >= 0.99, 0 where a denominator is: exact on crafted
    rolls, a ragged length (t % 3 = 2) and a partly masked row."""
    rng = np.random.default_rng(37)
    b, t, f = 2, 14, 5
    gt = (rng.random((b, t, f)) > 0.6).astype(np.float32)
    probs = {"random": rng.random((b, t, f)).astype(np.float32),
             "perfect": gt, "empty": np.zeros((b, t, f), np.float32),
             "masked": gt * 0.45}[case]
    mask = np.ones((b, t), bool)
    if case in ("random", "masked"):
        mask[1, 7:] = False
    got = t_cfm.roll_metrics(T(probs), T(gt), T(mask))
    want = j_cfm._roll_metrics(jnp.asarray(probs), jnp.asarray(gt),
                               jnp.asarray(mask))
    for a, b_ in zip(got, want):
        assert float(a) == float(b_)
    if case == "perfect":
        assert [float(x) for x in got] == [1.0] * 4


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def v2p_trained(request):
    """One V2P Trainer.train_step each side (lr 1e-3, warmup 2, EMA 0.9,
    midi_loss_weight 10) from the same weights and draws."""
    accum = request.param
    jm, tm, cfg, cond = _pair(38)
    before = {k: np.array(v) for k, v in flatten_jax(jm).items()}
    kw = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=1000,
              use_ema=True, ema_decay=0.9, grad_accum=accum)
    rng_np = np.random.default_rng(39)
    parts = [_batch(rng_np, cfg) for _ in range(accum)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    rng = jax.random.key(40)
    keys = ([jax.random.split(rng)[0]] if accum == 1 else
            [jax.random.split(jax.random.fold_in(rng, i))[0]
             for i in range(accum)])
    jt = j_trainer.Trainer(jm, j_config.TrainConfig(**kw))
    loss_j, bk_j = jt.train_step(rng, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tt = t_trainer.Trainer(tm, t_config.TrainConfig(**kw))
    draws = [jax_draws(k, B, N_LAT, cfg.num_channels, cond) for k in keys]
    loss_t, bk_t = tt.train_step({k: T(v) for k, v in batch.items()},
                                 draws=draws[0] if accum == 1 else draws)
    return dict(jm=jm, tm=tm, jt=jt, tt=tt, before=before,
                loss=(float(loss_j), loss_t.item()), bk=(bk_j, bk_t))


def _port_layout(tm, flat):
    out = {}
    for key, arr in flat.items():
        name, transform = t_convert._target(tm, key)
        out[name] = np.asarray(transform(np.asarray(arr)))
    return out


def test_v2p_train_step_matches_jax(v2p_trained):
    """Loss, MIDI loss and F1, the updated parameters (Video2Roll's
    included) and the EMA shadow agree."""
    tp = v2p_trained
    tm = tp["tm"]
    np.testing.assert_allclose(tp["loss"][1], tp["loss"][0], rtol=1e-5)
    bk_j, bk_t = tp["bk"]
    for f in ("flow", "midi", "f1"):
        np.testing.assert_allclose(float(getattr(bk_t, f)),
                                   float(getattr(bk_j, f)), rtol=1e-5)
    after_j = _port_layout(tm, flatten_jax(tp["jm"]))
    before = _port_layout(tm, tp["before"])
    shadow_j = _port_layout(tm, flatten_jax(tp["jt"].ema.shadow))
    lr = 1e-3 * 0.01
    moved = 0
    for name, p in tm.named_parameters():
        # Adam's first update is +-lr g/|g|: a gradient at rounding level
        # may flip sign between the frameworks and move by 2 lr
        err = np.abs(N(p) - after_j[name])
        assert np.all(err <= 2 * lr + 1e-6), (name, float(err.max()))
        assert np.mean(err <= 1e-6) > 0.99, name
        np.testing.assert_allclose(N(tp["tt"].ema.shadow[name]),
                                   shadow_j[name], atol=2 * lr + 1e-6)
        moved += int(np.any(N(p) != before[name]))
    assert moved == len(list(tm.parameters()))


# --------------------------------------------------------- bf16 first moment

def test_mu_bf16_matches_optax():
    """Fed identical gradients over 3 steps (one above the clip, a zero
    gradient with weight decay), the port's bf16-moment AdamW equals
    optax's adamw(mu_dtype=bf16): parameters to 1e-6, the stored first
    moment bf16 and equal, the second moment to 1e-6 relative."""
    rng = np.random.default_rng(41)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * scale
              for s in shapes] for scale in (2.0, 0.05, 0.1)]
    grads[1][2][:] = 0.0
    kw = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10,
              mu_bf16=True)
    tx = j_trainer.make_tx(j_config.TrainConfig(**kw))
    state = tx.init(params)
    tp = [torch.nn.Parameter(T(p)) for p in params]
    opt = t_trainer.make_tx(t_config.TrainConfig(**kw), tp)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, gi in zip(tp, g):
            p.grad = T(gi)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-6)
        adam = state[1][0]
        for mu_t, mu_j, nu_t, nu_j in zip(opt.adamw.mu, adam.mu,
                                          opt.adamw.nu, adam.nu):
            assert mu_t.dtype == torch.bfloat16 and mu_j.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                N(mu_t.float()), np.asarray(mu_j.astype(jnp.float32)))
            np.testing.assert_allclose(N(nu_t), np.asarray(nu_j), rtol=1e-6)
    assert opt.count == 3


def test_mu_bf16_state_round_trips():
    """``state_dict`` / ``load_state_dict`` carry the bf16 moment, the
    second moment and the count: a restored optimizer takes the same next
    step."""
    rng = np.random.default_rng(42)
    cfg = t_config.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                               mu_bf16=True)
    a = [torch.nn.Parameter(T(rng.normal(size=(4, 3))))]
    b = [torch.nn.Parameter(a[0].detach().clone())]
    opt_a, opt_b = t_trainer.make_tx(cfg, a), t_trainer.make_tx(cfg, b)
    g = T(rng.normal(size=(4, 3)))
    for _ in range(2):
        a[0].grad = g.clone()
        opt_a.step()
    opt_b.load_state_dict(opt_a.state_dict())
    b[0].data.copy_(a[0].data)
    for p, o in ((a, opt_a), (b, opt_b)):
        p[0].grad = g.clone()
        o.step()
    assert torch.equal(a[0], b[0]) and opt_b.count == 3
    assert torch.equal(opt_a.adamw.mu[0], opt_b.adamw.mu[0])


# ------------------------------------------------------------------ remat

def _port_grads(tm, batch, draws, seed):
    tm.zero_grad(set_to_none=True)
    tm.dropout_generator.manual_seed(seed)
    out = _port_loss(tm, batch, draws=draws)
    out.loss.backward()
    return (out.loss.item(), {k: p.grad.clone() for k, p in
                              tm.named_parameters() if p.grad is not None},
            tm.dropout_generator.get_state())


@pytest.fixture(scope="module")
def remat_models():
    """The same weights in three port CFMs at dropout 0.1: no remat, remat
    "full" and remat "dots"."""
    jm, tm, cfg, cond = _pair(43, dropout=0.1)
    flat = flatten_jax(jm)
    out = {"none": tm}
    for policy in ("full", "dots"):
        _, tcfg = model_cfgs(**{**SMALL, "dropout": 0.1, "remat": True,
                                "remat_policy": policy})
        m = t_cfm.CFM(tcfg, cond, with_video2roll=True, device="cpu")
        t_convert.load_jax_params(m, flat)
        out[policy] = m
    return out, cfg, cond


@pytest.mark.parametrize("chunk", [None, 4], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_no_remat(remat_models, policy, chunk,
                                        monkeypatch):
    """At dropout 0.1 and the same generator seed, remat gives the loss and
    gradients of the step without it (the recompute draws the forward's
    dropout masks), and leaves the dropout generator where the step
    without remat leaves it; another seed gives other gradients. With
    Video2Roll's 10 windows in one recomputed chunk every gradient is
    within 1e-6 of its scale; in chunks of 4 windows (whose convolutions
    may block otherwise, and whose weight gradients sum over the chunks)
    the loss is within 1e-6 relative and every gradient within 1e-4
    relative RMS."""
    models, cfg, cond = remat_models
    if chunk is not None:
        monkeypatch.setattr(t_cfm, "V2R_REMAT_CHUNK", chunk)
    batch = _batch(np.random.default_rng(44), cfg)
    draws = jax_draws(jax.random.key(45), B, N_LAT, cfg.num_channels, cond)
    loss0, g0, state0 = _port_grads(models["none"], batch, draws, 7)
    loss1, g1, state1 = _port_grads(models[policy], batch, draws, 7)
    assert torch.equal(state0, state1)
    assert set(g1) == set(g0)
    if chunk is None:
        assert loss1 == loss0
        for name, g in g0.items():
            tol = 1e-6 * max(1.0, g.abs().max().item())
            assert (g1[name] - g).abs().max().item() <= tol, name
    else:
        assert loss1 == pytest.approx(loss0, rel=1e-6)
        for name, g in g0.items():
            assert rel_rms(N(g1[name]), N(g)) < 1e-4, name
    _, g2, _ = _port_grads(models[policy], batch, draws, 8)
    assert not torch.allclose(g2["to_pred.weight"], g0["to_pred.weight"])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_jax_remat(policy):
    """At dropout 0, the port's remat step against JAX's nnx.remat (with
    its policy): loss and gradients."""
    jm, tm, cfg, cond = _pair(46, remat=True, remat_policy=policy)
    batch = _batch(np.random.default_rng(47), cfg)
    key = jax.random.key(48)
    (loss_j, _), grads_j = _jax_value_and_grad(jm, batch, rng=key)
    out = _port_loss(tm, batch,
                     draws=jax_draws(key, B, N_LAT, cfg.num_channels, cond))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(loss_j), rtol=1e-5)
    _check_grads(tm, grads_j)


def test_unknown_remat_policy_raises():
    _, tcfg = model_cfgs(remat=True, remat_policy="offload")
    with pytest.raises(ValueError, match="remat policy"):
        t_cfm.CFM(tcfg, device="cpu")


def test_remat_keeps_video2roll_activations_to_its_chunks():
    """Without remat, Video2Roll's saved activations grow by ~65 MB a
    5 x 100 x 900 window in bf16 (8 x 251 windows: ~120 GiB); under remat
    ``encode_frames`` keeps only each chunk's input and output, under a
    tenth of that, and gives the same roll."""
    cond = t_config.tiny_test().conditioning
    frames = T(np.random.default_rng(49).random((1, 3, 100, 900)))
    saved = {}
    rolls = {}
    for remat in (False, True):
        _, tcfg = model_cfgs(**SMALL, dtype="bfloat16", remat=remat)
        torch.manual_seed(0)
        m = t_cfm.CFM(tcfg, cond, with_video2roll=True, device="cpu")
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            rolls[remat] = m.encode_frames(frames, 6)
        saved[remat] = sum(sizes)
    per_window = saved[False] / 3
    assert 40e6 < per_window < 100e6, per_window
    assert saved[True] < saved[False] / 10, saved
    torch.testing.assert_close(rolls[True], rolls[False], rtol=0, atol=0)
