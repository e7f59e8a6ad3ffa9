"""The port's parallelism (``v2ap_torch.parallel``) against the unsharded
port and against the JAX package's sharded step, on the CPU in float32.

The mesh and the sharding rules are checked in this process. The sharded
paths run through the multichip dry run (``python -m
v2ap_torch.parallel.dryrun``): one run with 2 ranks (TP 2) and one with 4
(DP 2 x TP 2), gloo over a ``file://`` store in ``tmp_path``, each shared
by this module's tests through a module-scoped fixture. Both start from
the weights of a randomised JAX ``dryrun_test`` CFM (with Video2Roll) and
take the JAX key's seven loss draws; the JAX reference is JAX's own
sharded step (``shard_model`` with ``model_parallel=2`` on the 8-device
virtual mesh) and its sharded 2-step sample on the post-step weights.

Tolerances, as the unsharded step's parity tests
(``tests/test_torch_training.py``): losses rtol 1e-5; every updated tensor,
the samples and the waveforms within rel-RMS 1e-4 (reduction orders
differ across shards). The DPO + FactorCL step is held through its
gradients (1e-4): Adam's first update is about +-lr wherever |g| >> eps,
so a parameter repeats its gradient's sign, not its size. A checkpoint
saved under TP 2 loads bit-equal in one process.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.sharding import PartitionSpec as P

from tests.test_torch_ops import flatten_jax, randomize_jax
from tests.test_torch_training import jax_draws
from v2ap_torch import config as t_config
from v2ap_torch.models.cfm import CFM as TCFM
from v2ap_torch.parallel import dryrun
from v2ap_torch.parallel.distributed import (all_hosts_mean,
                                             host_shard_info,
                                             init_distributed)
from v2ap_torch.parallel.sharding import param_spec
from v2ap_torch.utils import convert as t_convert
from v2ap_torch.utils.checkpoint import load_model
from v2ap_tpu import config as j_config
from v2ap_tpu.models.cfm import CFM as JCFM

torch.set_num_threads(2)
TOL_LOSS, TOL_REL = 1e-5, 1e-4
MESHES = {"tp2": (2, 2), "dp2tp2": (4, 2)}


# ------------------------------------------------------- mesh and rules

def test_make_mesh_shapes():
    """As ``tests/test_parallel.py``: 8 ranks make a 4 x 2 mesh at
    model_parallel 2 and 8 x 1 by default, rank r at (r // mp, r % mp);
    without a process group make_mesh raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from v2ap_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(t_config.MeshConfig())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh(t_config.MeshConfig(model_parallel=2))
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (4, 2)
        assert mesh.mesh.tolist() == np.arange(8).reshape(4, 2).tolist()
        assert tuple(make_mesh(t_config.MeshConfig()).mesh.shape) == (8, 1)
        with pytest.raises(AssertionError, match="mesh"):
            make_mesh(t_config.MeshConfig(model_parallel=3))
    finally:
        dist.destroy_process_group()


def test_shard_model_places_projections():
    """As ``tests/test_parallel.py``'s placement test, on rank 0 of a fake
    8-rank group (4 x 2; nothing is exchanged): the fused qkv holds this
    rank's q, k and v heads, ``to_out`` its input columns, the GLU's
    ``proj_in`` its value and gate rows, the norms stay whole; every
    placement ``state_shardings`` names follows ``param_spec``; the
    attention runs its local heads, the dropouts take their rows and
    columns; a checkpoint's full state shards back exactly."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from v2ap_torch.parallel import make_mesh, shard_model, state_shardings
    from v2ap_torch.parallel.state import shard_like

    cfg = t_config.dryrun_test()
    m = TCFM(cfg.model, cfg.conditioning, device="cpu", with_video2roll=True)
    full = {k: v.clone() for k, v in m.state_dict().items()}
    specs = {k: param_spec(k, p, 2) for k, p in m.named_parameters()}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        shard_model(m, make_mesh(t_config.MeshConfig(model_parallel=2)))
    finally:
        dist.destroy_process_group()
    attn = m.transformer.audio_blocks[0].attn
    inner = cfg.model.heads * cfg.model.dim_head
    q, k, v = full["transformer.audio_blocks.0.attn.to_qkv.weight"].chunk(3)
    half = inner // 2
    assert torch.equal(attn.to_qkv.weight, torch.cat(
        [q[:half], k[:half], v[:half]]))
    assert attn.heads == cfg.model.heads // 2 and attn.tp[1] == 0
    assert attn.to_out.weight.shape == (cfg.model.dim, half)
    assert attn.dropout.cols == (2, 0) and attn.dropout.rows == (4, 0)
    ff = m.transformer.audio_blocks[0].ff
    val, gate = full["transformer.audio_blocks.0.ff.proj_in.weight"].chunk(2)
    n = val.shape[0] // 2
    assert torch.equal(ff.proj_in.weight, torch.cat([val[:n], gate[:n]]))
    assert m.transformer.final_norm.g.shape == (cfg.model.dim,)
    placed = state_shardings(m)
    assert set(placed) == set(specs)
    for name, p in m.named_parameters():
        want = Replicate() if specs[name] is None else Shard(specs[name])
        assert placed[name] == want, name
        assert torch.equal(p.detach(), shard_like(p, full[name])), name


def test_distributed_helpers_single_process(monkeypatch):
    """As ``tests/test_parallel.py``: in one process ``init_distributed`` is
    a no-op returning False; several processes without a rank or a
    coordinator raise instead of carrying on as one. Under torchrun the
    world size is ``WORLD_SIZE``: ``V2AP_NUM_HOSTS`` counts hosts (1 host
    of 4 processes goes on to the rendezvous), and a host count or a
    ``num_processes`` that contradicts it raises."""
    for var in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK", "MASTER_ADDR",
                "MASTER_PORT", "V2AP_NUM_HOSTS"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert host_shard_info() == (0, 1)
    assert all_hosts_mean(3.5) == 3.5
    monkeypatch.setenv("V2AP_NUM_HOSTS", "1")
    assert init_distributed() is False            # JAX's gate
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="rank"):
        init_distributed(device="cpu")            # one host, 4 processes
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("V2AP_NUM_HOSTS", "2")
    with pytest.raises(RuntimeError, match="contradicts"):
        init_distributed(device="cpu")
    monkeypatch.delenv("V2AP_NUM_HOSTS")
    with pytest.raises(RuntimeError, match="num_processes"):
        init_distributed(num_processes=2, device="cpu")
    with pytest.raises(RuntimeError, match="rank"):
        init_distributed(device="cpu")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="coordinator"):
        init_distributed(device="cpu")


def test_tp_products_round_partials_once():
    """The tensor-parallel products in bf16, their autograd functions run
    outside a process group (the sums skip): ``row_partial``'s forward is the float32 product of
    the operands (exact on bf16 values), its gradients the bf16 product's;
    ``column_product``'s forward is ``F.linear``'s and its input gradient
    the float32 product rounded once. Tolerances: forward exact; gradients
    within one bf16 rounding (rtol 2**-8) of ``F.linear``'s."""
    from v2ap_torch.parallel.distributed import _ColumnProduct, row_partial

    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape),
                            dtype=torch.bfloat16).requires_grad_()

    x, w, b, g = t(3, 5, 16), t(12, 16), t(12), t(3, 5, 12)
    one = dict(rtol=2.0 ** -8, atol=0.0)

    def grads(fn, *args):
        out = fn(*args)
        gs = torch.autograd.grad(out, args, g.to(out.dtype))
        return out, gs

    y, (gx, gw) = grads(row_partial, x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float().T, rtol=0, atol=0)
    _, (rx, rw) = grads(torch.nn.functional.linear, x, w)
    torch.testing.assert_close(gx, rx, **one)
    torch.testing.assert_close(gw, rw, **one)
    y, (gx, gw, gb) = grads(lambda *a: _ColumnProduct.apply(*a, None),
                            x, w, b)
    ref, (rx, rw, rb) = grads(torch.nn.functional.linear, x, w, b)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    torch.testing.assert_close(gx, (g.float() @ w.float()).to(x.dtype), **one)
    for a, r in ((gx, rx), (gw, rw), (gb, rb)):
        torch.testing.assert_close(a, r, **one)


def _jax_spec_dim(spec, ndim):
    """JAX's PartitionSpec of a kernel (in, out) as the port's dim of
    weight (out, in): column (last dim) -> 0, row -> 1, P() -> None."""
    if spec == P():
        return None
    axes = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return {ndim - 1: 0, ndim - 2: 1}[axes.index("model")]


def _jax_models():
    from v2ap_tpu.models.clip_vit import CLIPVisionModel, clip_tiny_test
    from v2ap_tpu.models.t5 import T5Encoder, t5_tiny_test
    from v2ap_torch.models.clip_vit import (CLIPVisionModel as TCLIP,
                                            clip_tiny_test as t_clip)
    from v2ap_torch.models.t5 import T5Encoder as TT5, t5_tiny_test as t_t5

    cfg = j_config.dryrun_test()
    tcfg = t_config.dryrun_test()
    return {
        "cfm": (lambda: JCFM(cfg.model, cfg.conditioning,
                             with_video2roll=True, rngs=nnx.Rngs(0)),
                lambda: TCFM(tcfg.model, tcfg.conditioning, device="meta",
                             with_video2roll=True)),
        "t5": (lambda: T5Encoder(t5_tiny_test(), rngs=nnx.Rngs(0)),
               lambda: TT5(t_t5(), device="meta")),
        "clip": (lambda: CLIPVisionModel(clip_tiny_test(), rngs=nnx.Rngs(0)),
                 lambda: TCLIP(t_clip(), device="meta")),
    }


@pytest.mark.parametrize("which", ["cfm", "t5", "clip"])
def test_param_spec_matches_jax(which):
    """``param_spec`` on every parameter of the tiny CFM (with Video2Roll),
    T5 and CLIP, at a model axis of 2, is JAX's ``param_spec`` on the JAX
    names, with the dims transposed; the JAX models are built abstractly."""
    from v2ap_tpu.parallel.sharding import param_spec as j_spec

    jbuild, tbuild = _jax_models()[which]
    jm = nnx.eval_shape(jbuild)
    tm = tbuild()
    tparams = dict(tm.named_parameters())
    seen, split = set(), 0
    for path, var in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        key = ".".join(map(str, path))
        name, _ = t_convert._target(tm, key)
        value = var.get_value()
        want = _jax_spec_dim(j_spec(path, value, "model", 2),
                             len(value.shape))
        got = param_spec(name, tparams[name], 2)
        assert got == want, (key, name, got, want)
        seen.add(name)
        split += got is not None
    assert seen == set(tparams)
    assert split > 0
    assert all(param_spec(n, p, 1) is None for n, p in tparams.items())


# -------------------------------------------------------------- dry runs

def _jax_cfm(mcfg, cond):
    """The JAX CFM with Video2Roll, built from its abstract shapes (an
    eager init compiles every initialiser): parameters zero (the caller
    randomises them), BatchNorm statistics at their init (mean 0, var 1),
    the time embedding's fixed Fourier weights seeded normals, the RNG
    streams keyed."""
    abstract = nnx.eval_shape(lambda: JCFM(mcfg, cond, with_video2roll=True,
                                           rngs=nnx.Rngs(0)))
    graphdef, state = nnx.split(abstract)
    rng = np.random.default_rng(30)
    flat = []
    for path, var in nnx.to_flat_state(state):
        v = var.get_value()
        if jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key):
            val = jax.random.key(0)
        elif isinstance(var, nnx.Param) or path[-1] == "mean":
            val = jnp.zeros(v.shape, v.dtype)
        elif path[-1] == "var":
            val = jnp.ones(v.shape, v.dtype)
        elif jnp.issubdtype(v.dtype, jnp.floating):
            val = jnp.asarray(rng.normal(size=v.shape), v.dtype)
        else:
            val = jnp.zeros(v.shape, v.dtype)
        flat.append((path, var.replace(val)))
    return nnx.merge(graphdef, nnx.from_flat_state(flat))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A randomised JAX dryrun_test CFM (Video2Roll, dropout 0) as the
    port's init file, the JAX key's draws, and JAX's sharded step and
    2-step sample on the 8-device mesh at model_parallel 2."""
    from v2ap_tpu.config import MeshConfig, SamplerConfig, TrainConfig
    from v2ap_tpu.parallel import (batch_sharding, make_mesh, replicated,
                                   shard_model)
    from v2ap_tpu.training.trainer import Trainer

    d = tmp_path_factory.mktemp("jax_ref")
    jcfg = j_config.dryrun_test()
    mcfg = dataclasses.replace(jcfg.model, dropout=0.0)
    jm = _jax_cfm(mcfg, jcfg.conditioning)
    randomize_jax(jm, 31, scale=0.05)
    tcfg = t_config.dryrun_test()
    tm = TCFM(tcfg.model, tcfg.conditioning, device="cpu",
              with_video2roll=True)
    t_convert.load_jax_params(tm, flatten_jax(jm))
    torch.save(tm.state_dict(), d / "init.pt")
    batch = dryrun.dryrun_batch(tcfg)
    b, n, c = batch["latents"].shape
    rng = jax.random.key(7)
    draws = jax_draws(jax.random.split(rng)[0], b, n, c, jcfg.conditioning)
    np.savez(d / "draws.npz", **{k: v.numpy() for k, v in
                                 draws._asdict().items()})

    mesh = make_mesh(MeshConfig(model_parallel=2), jax.devices())
    shard_model(jm, mesh)
    bs = batch_sharding(mesh)
    trainer = Trainer(jm, TrainConfig(learning_rate=1e-3, warmup_steps=2,
                                      decay_steps=100))
    loss, _ = trainer.train_step(rng, {k: jax.device_put(jnp.asarray(v), bs)
                                       for k, v in batch.items()})
    params = {}
    for key, arr in flatten_jax(jm).items():
        name, transform = t_convert._target(tm, key)
        params[name] = np.asarray(transform(np.asarray(arr)))
    s = dryrun.dryrun_sample_inputs(tcfg)
    sb = s["x0"].shape[0]
    put = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                   replicated(mesh))
    sample = nnx.jit(lambda m, *a: m.sample(
        a[0], text_embed=a[1], frames_embed=a[2], context=a[3],
        context_mask=a[4], mask=a[5], sampler=SamplerConfig(
            steps=2, cfg_strength=2.0, sway_sampling=True)))
    lat = sample(jm, put(s["x0"]), put(s["text"]), put(s["roll"]),
                 put(s["ctx"]), put(np.ones((sb, dryrun.N_CTX), bool)),
                 put(np.ones((sb, n), bool)))
    return dict(dir=d, loss=float(loss), params=params,
                sample=np.asarray(lat), lens=batch["lens"])


@pytest.fixture(scope="module", params=sorted(MESHES))
def dry(request, jax_run, tmp_path_factory):
    """One dry run per mesh through the CLI (``main``), its printed JSON
    summary and its arrays."""
    world, mp = MESHES[request.param]
    out = tmp_path_factory.mktemp(f"dry_{request.param}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert dryrun.main([
            "--world-size", str(world), "--model-parallel", str(mp),
            "--device", "cpu", "--out", str(out), "--timeout", "400",
            "--init", str(jax_run["dir"] / "init.pt"),
            "--draws", str(jax_run["dir"] / "draws.npz")]) == 0
    summary = json.loads(printed.getvalue().strip().splitlines()[-1])
    z = dict(np.load(out / "dryrun.npz"))
    return dict(name=request.param, world=world, mp=mp, out=out,
                summary=summary, z=z)


def _worst(z, name, kind):
    vals = z[f"{name}/{kind}_rel_rms"]
    names = z[f"{name}/{kind}_rel_rms_names"]
    i = int(np.argmax(vals))
    return float(vals[i]), str(names[i])


def test_dryrun_rows_of_unequal_lengths(dry):
    """Each data rank's masked count differs (a mean of the ranks' means
    would not be the global batch's loss), and every rank ran."""
    lens = dryrun.dryrun_batch(t_config.dryrun_test())["lens"]
    dp = dry["world"] // dry["mp"]
    counts = lens.reshape(dp, -1).sum(-1)
    assert dp == 1 or len(set(counts.tolist())) == dp
    for r in range(dry["world"]):
        assert (dry["out"] / f"rank{r}.log").exists()


def test_sharded_train_step_matches_unsharded(dry):
    z = dry["z"]
    np.testing.assert_allclose(z["train/loss"], z["train_ref/loss"],
                               rtol=TOL_LOSS)
    for field in ("flow", "midi", "f1"):
        np.testing.assert_allclose(z[f"train/{field}"],
                                   z[f"train_ref/{field}"], rtol=TOL_LOSS,
                                   atol=1e-7)
    assert z["train/midi"] > 0
    worst, name = _worst(z, "train", "param")
    assert worst < TOL_REL, name


def test_sharded_train_step_matches_jax(dry, jax_run):
    """The gathered post-step parameters and the loss equal JAX's sharded
    step at the same weights and draws."""
    z = dry["z"]
    np.testing.assert_allclose(z["train/loss"], jax_run["loss"],
                               rtol=TOL_LOSS)
    for name, want in jax_run["params"].items():
        got = z[f"train/{name}"]
        assert got.shape == want.shape, name
        assert dryrun.rel_rms(got, want) < TOL_REL, name


def test_sharded_sample_matches_unsharded_and_jax(dry, jax_run):
    z = dry["z"]
    assert np.isfinite(z["sample"]).all()
    assert dryrun.rel_rms(z["sample"], z["sample_ref"]) < TOL_REL
    assert dryrun.rel_rms(z["sample"], jax_run["sample"]) < TOL_REL


def test_sharded_dropout_step_matches_unsharded(dry):
    """Dropout 0.1: the global masks, each rank's rows and columns."""
    z = dry["z"]
    np.testing.assert_allclose(z["dropout/loss"], z["dropout_ref/loss"],
                               rtol=TOL_LOSS)
    worst, name = _worst(z, "dropout", "param")
    assert worst < TOL_REL, name


def test_sharded_dpo_contrastive_step_matches_unsharded(dry):
    z = dry["z"]
    for field in ("loss", "dpo", "contrastive"):
        assert z[f"dpo/{field}"] != 0 and np.isfinite(z[f"dpo/{field}"])
        np.testing.assert_allclose(z[f"dpo/{field}"], z[f"dpo_ref/{field}"],
                                   rtol=TOL_LOSS)
    worst, name = _worst(z, "dpo", "grad")
    assert worst < TOL_REL, name


def test_shard_serving_and_generate_long_match_unsharded(dry):
    z, s = dry["z"], dry["summary"]
    assert s["long_chunks"] == 3
    for key in ("serve", "long"):
        assert z[f"{key}/wav"].shape == z[f"{key}_ref/wav"].shape
        assert dryrun.rel_rms(z[f"{key}/wav"], z[f"{key}_ref/wav"]) < TOL_REL


def test_tp_checkpoint_loads_bit_equal_in_one_process(dry):
    """``save_model`` under the mesh wrote the gathered tensors; one process
    loads them into an unsharded CFM exactly."""
    cfg = t_config.dryrun_test()
    m = TCFM(cfg.model, cfg.conditioning, device="cpu", with_video2roll=True)
    load_model(str(dry["out"] / "ckpt"), m)
    for name, t in m.state_dict().items():
        if name in dict(m.named_parameters()):
            np.testing.assert_array_equal(t.numpy(), dry["z"][f"train/{name}"],
                                          err_msg=name)


def test_dryrun_cli_prints_summary(dry):
    """``python -m v2ap_torch.parallel.dryrun`` printed its JSON summary
    as its last line, with the mesh and every phase's figures."""
    s = dry["summary"]
    assert (s["world_size"], s["model_parallel"]) == (dry["world"],
                                                      dry["mp"])
    assert s["data_parallel"] * s["model_parallel"] == s["world_size"]
    for key in ("train_param_rel_rms", "dropout_param_rel_rms",
                "dpo_grad_rel_rms", "sample_rel_rms", "serve_rel_rms",
                "long_rel_rms"):
        assert 0 <= s[key] < TOL_REL, key


def test_dryrun_failing_rank_fails_the_run(tmp_path):
    """A rank that fails (a 2 x 3 mesh over 2 ranks) fails the run with its
    log, and every rank process has ended."""
    with pytest.raises(RuntimeError, match="rank"):
        dryrun.run_dryrun(2, 3, str(tmp_path), device="cpu", timeout=120,
                          phases="sample")
