"""Parity of the port's reflow distillation (``v2ap_torch.training.distill``
and ``python -m v2ap_torch.distill``) with the JAX package's, on the CPU in
float32, tiny config, dropout 0.

The schedule equals optax's at every step of the warm-up and the decay
(1e-6 relative); one ``distill_step`` at the same coupled x0 and JAX's
draws gives the same loss (1e-5 relative) and parameters (1e-5 relative
RMS); the pair sampler the same x1 from the same x0 (1e-4 relative RMS:
CFG-guided Euler steps through the transformer); ``fewstep_sampler`` is
the pipeline's few-step sampler.
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
from tests.test_torch_training import jax_draws
from v2ap_torch import config as t_config
from v2ap_torch import distill as t_distill_cli
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.training import distill as t_distill
from v2ap_torch.utils import convert as t_convert
from v2ap_tpu.models import cfm as j_cfm
from v2ap_tpu.training import distill as j_distill

torch.set_num_threads(2)

B, N_LAT = 2, 24


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = model_cfgs(dropout=0.0, depth=2, text_depth=2)
    jm = j_cfm.CFM(jcfg, with_video2roll=False, rngs=nnx.Rngs(0))
    randomize_jax(jm, 60, scale=0.05)
    tm = t_cfm.CFM(tcfg, t_config.tiny_test().conditioning, device="cpu")
    t_convert.load_jax_params(tm, flatten_jax(jm))
    rng = np.random.default_rng(61)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    cond = dict(text=r(B, N_LAT, jcfg.dim_text),
                ctx=r(B, 1, jcfg.dim_context), cmask=np.ones((B, 1), bool),
                mask=np.ones((B, N_LAT), bool),
                frames=np.zeros((B, N_LAT, jcfg.notes), np.float32))
    return jm, tm, jcfg, cond


def test_reflow_config_and_schedule_match_optax():
    assert dataclasses.asdict(t_distill.ReflowConfig()) == \
        dataclasses.asdict(j_distill.ReflowConfig())
    cfg = t_distill.ReflowConfig(learning_rate=2e-3, warmup_steps=5,
                                 decay_steps=10)
    lr = cfg.learning_rate
    want = optax.join_schedules(
        [optax.linear_schedule(lr * 0.01, lr, cfg.warmup_steps),
         optax.linear_schedule(lr, lr * 0.01, cfg.decay_steps)],
        [cfg.warmup_steps])
    _, tcfg = model_cfgs(depth=2, text_depth=2)
    d = t_distill.ReflowDistiller(t_cfm.CFM(tcfg, device="cpu"), cfg)
    for step in range(cfg.warmup_steps + cfg.decay_steps + 3):
        np.testing.assert_allclose(d.optimizer.schedule(step),
                                   float(want(step)), rtol=1e-6)
    assert d.optimizer.adamw.param_groups[0]["weight_decay"] == 1e-4


def test_distill_step_matches_jax(pair):
    """One step of each distiller (clip, then adamw with weight decay 1e-4)
    from the same weights at the same coupled (x0, x1) and JAX's draws."""
    jm, tm, cfg, cond = pair
    rcfg = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=100)
    jstudent = nnx.clone(jm)
    tstudent = t_cfm.CFM(tm.cfg, tm.cond_cfg, device="cpu")
    tstudent.load_state_dict(tm.state_dict())
    rng = np.random.default_rng(62)
    x0 = rng.normal(size=(B, N_LAT, cfg.num_channels)).astype(np.float32)
    x1 = rng.normal(size=(B, N_LAT, cfg.num_channels)).astype(np.float32)
    lens = np.array([N_LAT, N_LAT - 5], np.int32)
    key = jax.random.key(3)
    jd = j_distill.ReflowDistiller(jstudent, j_distill.ReflowConfig(**rcfg))
    loss_j = jd.distill_step(key, jnp.asarray(x0), jnp.asarray(x1),
                             lens=jnp.asarray(lens),
                             text_embed=jnp.asarray(cond["text"]),
                             context=jnp.asarray(cond["ctx"]),
                             context_mask=jnp.asarray(cond["cmask"]))
    td = t_distill.ReflowDistiller(tstudent, t_distill.ReflowConfig(**rcfg))
    draws = jax_draws(key, B, N_LAT, cfg.num_channels,
                      t_config.tiny_test().conditioning)
    loss_t = td.distill_step(T(x0), T(x1), lens=T(lens),
                             text_embed=T(cond["text"]), context=T(cond["ctx"]),
                             context_mask=T(cond["cmask"]), draws=draws)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert td.step == jd.step == 1
    want = {}
    for key_, arr in flatten_jax(jstudent).items():
        name, transform = t_convert._target(tstudent, key_)
        want[name] = np.asarray(transform(np.asarray(arr)))
    moved = 0
    for name, p in tstudent.named_parameters():
        assert rel_rms(N(p), want[name]) < 1e-5, name
        moved += int(not torch.equal(p, dict(tm.named_parameters())[name]))
    assert moved > 0


def test_pair_sampler_matches_jax(pair):
    """The teacher's guided sampler (sway steps, CFG 2.0) maps the same x0
    to the same x1; without x0 it draws one from the generator."""
    jm, tm, cfg, cond = pair
    rcfg = dict(teacher_steps=6, cfg_strength=2.0)
    key = jax.random.key(4)
    x0_j, x1_j = j_distill.make_pair_sampler(jm, j_distill.ReflowConfig(
        **rcfg))(key, jnp.asarray(cond["text"]), jnp.asarray(cond["frames"]),
                 jnp.asarray(cond["ctx"]), jnp.asarray(cond["cmask"]),
                 jnp.asarray(cond["mask"]))
    pairs = t_distill.make_pair_sampler(tm, t_distill.ReflowConfig(**rcfg))
    args = (T(cond["text"]), T(cond["frames"]), T(cond["ctx"]),
            T(cond["cmask"]), T(cond["mask"]))
    x0, x1 = pairs(*args, x0=T(np.asarray(x0_j)))
    assert not x1.requires_grad
    assert rel_rms(N(x1), np.asarray(x1_j)) < 1e-4
    a0, a1 = pairs(*args, generator=torch.Generator().manual_seed(2))
    b0, b1 = pairs(*args, generator=torch.Generator().manual_seed(2))
    assert a0.shape == x0.shape and torch.equal(a1, b1)


def test_fewstep_sampler_is_the_pipelines():
    from v2ap_torch.pipelines.generate import V2APipeline

    for steps in (2, 4):
        got = t_distill.fewstep_sampler(steps)
        assert got == V2APipeline._sampler(None, 25, 2.0, steps)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            j_distill.fewstep_sampler(steps))


def test_distill_cli_then_fewstep_generate(tmp_path, capsys):
    """``python -m v2ap_torch.distill --tiny --device cpu`` writes a student
    that the tiny serving pipeline loads and samples in 2 steps."""
    from v2ap_torch.models.clip_vit import clip_tiny_test
    from v2ap_torch.models.t5 import t5_tiny_test
    from v2ap_torch.pipelines.generate import V2APipeline
    from v2ap_torch.utils.checkpoint import save_model

    cfg = t_config.tiny_tower_test()
    pipe = V2APipeline(cfg, device="cpu", quantize_towers=False,
                       t5_config=t5_tiny_test(), clip_config=clip_tiny_test())
    teacher = tmp_path / "teacher"
    save_model(str(teacher), pipe.cfm)
    out = tmp_path / "student"
    assert t_distill_cli.main(
        ["--ckpt", str(teacher), "--out", str(out), "--tiny", "--device",
         "cpu", "--steps", "2", "--batch", "2", "--frames", "48",
         "--teacher-steps", "2"]) == 0
    log = capsys.readouterr().out
    assert "loaded teacher" in log and "reflow_loss" in log
    assert pipe.load_weights(str(out)) == ["cfm"]
    frames = np.random.default_rng(63).integers(0, 256, (12, 28, 28, 3),
                                                dtype=np.uint8)
    wav, sr = pipe.generate(None, fewstep=2, seed=1,
                            frames_cache=[(frames, 1.0, 1)])
    assert wav.shape == (24_000,) and np.isfinite(wav).all()
