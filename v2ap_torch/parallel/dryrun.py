"""The multichip dry run: every parallel path of the port, sharded over N
ranks, against the same work in one process.

    python -m v2ap_torch.parallel.dryrun --world-size 4 --model-parallel 2 \\
        --device cpu --out /tmp/dry

Counterpart of ``__graft_entry__.dryrun_multichip``. It starts N rank
processes (``python -m v2ap_torch.parallel.dryrun --rank r``; gloo on the
CPU, NCCL on CUDA unless ``--backend gloo``, which lets ranks share one
card), which meet through a ``file://`` store under ``--out`` and build the
(N / M) x M mesh of ``make_mesh`` over the ``dryrun_test`` config with
Video2Roll. Each rank runs, on its rows and its shards:

  * ``train``: one train step of a V2P batch (keyboard frames and MIDI),
    rows of different lengths, at dropout 0 (the weights of ``--init``
    and the global draws of ``--draws`` when given);
  * ``dropout``: one V2A step at dropout 0.1;
  * ``dpo``: one DPO + FactorCL step (8 rows, the pair in the last two),
    held through its gradients;
  * ``sample``: a 2-step CFG sample on ``train``'s post-step weights;
  * ``ckpt``: ``save_model`` of those weights (gathered, rank 0 writes);
  * ``serve``: ``V2APipeline.shard_serving`` + ``generate`` of a miniature
    pipeline (tiny towers, a prompt), and ``generate_long(mesh=)`` of a
    clip of 3 chunks (padded to the data axis).

Rank 0 then runs every one of them unsharded in its own process (the
single-process sample on the same post-step weights) and writes
``dryrun.npz``: the sharded step's gathered parameters (``train/<name>``),
per-tensor relative RMS differences against the unsharded step, the
samples and waveforms of both. The run fails (exit 1) if a rank fails, a
join times out (every rank is killed), or a sharded result leaves its
tolerance (float32: losses within rtol 1e-5; every gradient, the samples
and the waveforms within rel-RMS 1e-4; every updated tensor too on the
CPU). Adam's first update is about +-lr wherever |g| >> eps, so a
parameter repeats its gradient's sign: where a gradient is near zero, a
different summation order flips it, and on CUDA (whose GEMMs pick their
kernels by shape) the updated tensors are reported, and the gradients
held. The last line of the output is one JSON summary.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

TOL_LOSS, TOL_REL = 1e-5, 1e-4
B_TRAIN, B_DPO, N_LAT, N_CTX, T_FRAMES = 4, 8, 24, 4, 2


def rel_rms(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = float(np.sqrt(np.mean(b ** 2)))
    num = float(np.sqrt(np.mean((a - b) ** 2)))
    return num / den if den > 0 else num


def dryrun_batch(cfg, b: int = B_TRAIN, *, frames: bool = True,
                 seed: int = 0) -> dict:
    """The global batch of the dry run's steps (numpy): latents, rows of
    lengths n, n-5, n-9, n-1, ... (each rank's masked count differs),
    text, a context with its mask half-off on odd rows, and for a V2P batch
    keyboard frames (b, 2, 100, 900) and a sparse MIDI roll. The last two
    rows share their text and context (a preference pair)."""
    rng = np.random.default_rng(seed)
    mc = cfg.model
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    lens = np.array([N_LAT - (0, 5, 9, 1, 0, 3, 2, 7)[i % 8]
                     for i in range(b)], np.int32)
    text = r(b, N_LAT, mc.dim_text)
    context = r(b, N_CTX, mc.dim_context)
    text[-1], context[-1] = text[-2], context[-2]
    cmask = np.ones((b, N_CTX), bool)
    cmask[1::2, N_CTX // 2:] = False
    out = dict(latents=r(b, N_LAT, mc.num_channels), lens=lens,
               text_embed=text, context=context, context_mask=cmask)
    if frames:
        out["frames"] = rng.random(
            (b, T_FRAMES, cfg.conditioning.piano_frame_h,
             cfg.conditioning.piano_frame_w)).astype(np.float32)
        out["midis"] = (rng.random((b, N_LAT, mc.notes)) > 0.9
                        ).astype(np.float32)
    return out


def dryrun_sample_inputs(cfg, b: int = 2) -> dict:
    """The sample phase's inputs (numpy float32): x0, CLIP features, a zero
    roll and a prompt context (all valid), for a CFG sample of b rows."""
    rng = np.random.default_rng(3)
    mc = cfg.model
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(x0=r(b, N_LAT, mc.num_channels),
                text=r(b, N_LAT, mc.dim_text),
                roll=np.zeros((b, N_LAT, mc.notes), np.float32),
                ctx=r(b, N_CTX, mc.dim_context))


def _set_dropout(model, rate: float) -> None:
    from v2ap_torch.ops.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate


# ------------------------------------------------------------------ ranks

def _rank_main(args) -> None:
    import torch
    import torch.distributed as dist

    from v2ap_torch import config as cfglib
    from v2ap_torch.config import MeshConfig, TrainConfig
    from v2ap_torch.models.cfm import CFM, LossDraws
    from v2ap_torch.parallel import batch_sharding, make_mesh
    from v2ap_torch.parallel.distributed import init_distributed
    from v2ap_torch.parallel.state import full_state_dict, gather_like
    from v2ap_torch.training.trainer import Trainer
    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.device import seeded_init

    torch.set_num_threads(args.threads)
    rank, world = args.rank, args.world_size
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        # float32 products and convolutions in float32 (the tolerances are
        # float32's)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"file://{os.path.join(args.out, 'rdzv')}", world, rank,
                     backend=args.backend, device=device,
                     timeout_s=args.timeout)
    mesh = make_mesh(MeshConfig(model_parallel=args.model_parallel))
    rows = batch_sharding(mesh)
    main = rank == 0
    cfg = cfglib.dryrun_test()
    out, summary, t0 = {}, {}, time.perf_counter()

    def tens(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}

    with seeded_init(0, device):
        base = CFM(cfg.model, cfg.conditioning, device=device,
                   with_video2roll=True)
    if args.init:
        base.load_state_dict(torch.load(args.init, map_location=device,
                                        weights_only=True))

    summary["build_s"] = time.perf_counter() - t0

    def build():
        return copy.deepcopy(base)

    def step(tcfg, batch, rate, draws=None, seed=1):
        """The sharded step (every rank) and, on rank 0, the unsharded one
        from the same weights: (losses, trainers, per-tensor rel-RMS of the
        parameters and of the clipped gradients)."""
        model = build()
        _set_dropout(model, rate)
        ref = copy.deepcopy(model) if main else None
        tr = Trainer(model, tcfg, seed=seed, mesh=mesh)
        loss, bk = tr.train_step({k: rows.shard(v)
                                  for k, v in tens(batch).items()},
                                 draws=draws)
        full = full_state_dict(model)
        grads = {k: gather_like(p, p.grad)
                 for k, p in model.named_parameters()}
        if not main:
            return loss, bk, tr, full, None
        tr0 = Trainer(ref, tcfg, seed=seed)
        loss0, bk0 = tr0.train_step(tens(batch), draws=draws)
        params0 = dict(ref.named_parameters())
        diffs = {
            "param": {k: rel_rms(full[k].double().cpu(),
                                 params0[k].detach().double().cpu())
                      for k in params0},
            "grad": {k: rel_rms(grads[k].double().cpu(),
                                params0[k].grad.double().cpu())
                     for k in params0}}
        return (loss, bk, tr, full,
                dict(loss0=loss0, bk0=bk0, tr0=tr0, diffs=diffs))

    def record(name, loss, bk, ref, check_params=True):
        out[f"{name}/loss"] = np.float64(loss.item())
        summary[f"{name}_loss"] = float(loss.item())
        if ref is None:
            return
        out[f"{name}_ref/loss"] = np.float64(ref["loss0"].item())
        for kind in ("param", "grad"):
            d = ref["diffs"][kind]
            out[f"{name}/{kind}_rel_rms_names"] = np.array(sorted(d))
            out[f"{name}/{kind}_rel_rms"] = np.array([d[k] for k in sorted(d)])
            worst = max(d, key=d.get)
            summary[f"{name}_{kind}_rel_rms"] = d[worst]
            summary[f"{name}_{kind}_worst"] = worst
        summary[f"{name}_loss_ref"] = float(ref["loss0"].item())
        for field in ("flow", "midi", "f1", "dpo", "contrastive"):
            a, b = getattr(bk, field), getattr(ref["bk0"], field)
            out[f"{name}/{field}"] = np.float64(float(a))
            out[f"{name}_ref/{field}"] = np.float64(float(b))
        checks = [("loss", abs(loss.item() - ref["loss0"].item())
                   <= TOL_LOSS * abs(ref["loss0"].item())),
                  ("grad", summary[f"{name}_grad_rel_rms"] <= TOL_REL)]
        if check_params and device.type == "cpu":
            checks.append(("param",
                           summary[f"{name}_param_rel_rms"] <= TOL_REL))
        for what, ok in checks:
            if not ok:
                raise AssertionError(f"{name}: sharded {what} diverged from "
                                     f"the unsharded step: {summary}")

    phases = set(args.phases.split(","))
    train_tr = None
    if "train" in phases or "sample" in phases or "ckpt" in phases:
        draws = None
        if args.draws:
            z = np.load(args.draws)
            draws = LossDraws(*(torch.from_numpy(z[f]).to(device)
                                for f in LossDraws._fields))
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           decay_steps=100)
        loss, bk, train_tr, full, ref = step(
            tcfg, dryrun_batch(cfg), 0.0, draws)
        record("train", loss, bk, ref)
        if main:
            for k, v in full.items():
                out[f"train/{k}"] = v.float().cpu().numpy()
        summary["train_s"] = time.perf_counter() - t0
    if "ckpt" in phases:
        save_model(os.path.join(args.out, "ckpt"), train_tr.model)
    if "dropout" in phases:
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           decay_steps=100)
        loss, bk, _, _, ref = step(tcfg, dryrun_batch(cfg, frames=False,
                                                      seed=1), 0.1)
        record("dropout", loss, bk, ref)
        summary["dropout_s"] = time.perf_counter() - t0
    if "dpo" in phases:
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           decay_steps=100, dpo=True, contrastive=True)
        loss, bk, _, _, ref = step(tcfg, dryrun_batch(
            cfg, B_DPO, frames=False, seed=2), 0.1)
        # Adam's first update is ~ +-lr wherever |g| >> eps: the gradients
        # carry the comparison, the parameters are reported
        record("dpo", loss, bk, ref, check_params=False)
        summary["dpo_s"] = time.perf_counter() - t0
    if "sample" in phases:
        from v2ap_torch.config import SamplerConfig

        sampler = SamplerConfig(steps=2, cfg_strength=2.0, sway_sampling=True)
        s_in = tens(dryrun_sample_inputs(cfg))
        sb = s_in["x0"].shape[0]
        mask = torch.ones(sb, N_LAT, dtype=torch.bool, device=device)
        cmask = torch.ones(sb, N_CTX, dtype=torch.bool, device=device)

        def sample(model):
            with torch.no_grad():
                return model.sample(
                    s_in["x0"], text_embed=s_in["text"],
                    frames_embed=s_in["roll"], context=s_in["ctx"],
                    context_mask=cmask, mask=mask, sampler=sampler)

        lat = sample(train_tr.model)
        if main:
            single = build()
            single.load_state_dict(full)
            lat0 = sample(single)
            out["sample"] = lat.cpu().numpy()
            out["sample_ref"] = lat0.cpu().numpy()
            summary["sample_rel_rms"] = rel_rms(out["sample"],
                                                out["sample_ref"])
            if not summary["sample_rel_rms"] <= TOL_REL:
                raise AssertionError(f"sharded sample diverged: {summary}")
    summary["sample_s"] = time.perf_counter() - t0
    if "serve" in phases:
        summary.update(_serve(args, mesh, device, out, main))
    dist.barrier()
    summary["seconds"] = time.perf_counter() - t0
    if main:
        np.savez(os.path.join(args.out, "dryrun.npz"), **out)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f)
    dist.destroy_process_group()


def _serve(args, mesh, device, out: dict, main: bool) -> dict:
    """``shard_serving`` + ``generate`` and ``generate_long(mesh=)`` of a
    miniature pipeline against the same pipeline unsharded (rank 0)."""
    from v2ap_torch import config as cfglib
    from v2ap_torch.models.clip_vit import clip_tiny_test
    from v2ap_torch.models.t5 import t5_tiny_test
    from v2ap_torch.pipelines.generate import V2APipeline
    from v2ap_torch.pipelines.merge import generate_long

    cfg = cfglib.tiny_tower_test()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, video2roll=False))
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, size=(63, 32, 32, 3), dtype=np.uint8)
    dur = 2.5

    # two heads of 16 (the card's kernels take head dims 16, 32, 64, 104;
    # clip_tiny_test's are 8): one head a rank at TP 2
    clip = dataclasses.replace(clip_tiny_test(), num_heads=2)

    def pipe():
        return V2APipeline(cfg, device=device, t5_config=t5_tiny_test(),
                           clip_config=clip, quantize_towers=False)

    def run(p, mesh_):
        wav, _ = p.generate(None, "a dog barks", steps=2,
                            frames_cache=[(frames, dur, 1)])
        long, _ = generate_long(p, None, "", chunk_s=1.0, overlap_s=0.2,
                                steps=2, frames_cache=[(frames, dur, 1)],
                                mesh=mesh_)
        return wav, long

    p = pipe()
    p.shard_serving(mesh)
    wav, long = run(p, mesh)
    res = {}
    if main:
        wav0, long0 = run(pipe(), None)
        out.update({"serve/wav": wav, "serve_ref/wav": wav0,
                    "long/wav": long, "long_ref/wav": long0})
        res = dict(serve_rel_rms=rel_rms(wav, wav0),
                   long_rel_rms=rel_rms(long, long0),
                   long_chunks=3)
        for k in ("serve_rel_rms", "long_rel_rms"):
            if not res[k] <= TOL_REL:
                raise AssertionError(f"sharded serving diverged: {res}")
    return res


# ---------------------------------------------------------------- launcher

def run_dryrun(world_size: int, model_parallel: int, out: str, *,
               device: str = "cpu", backend: str | None = None,
               timeout: float = 600.0, threads: int | None = None,
               init: str | None = None, draws: str | None = None,
               phases: str = "train,dropout,dpo,sample,ckpt,serve") -> dict:
    """Start ``world_size`` rank processes, wait for them (killing all of
    them when one fails or ``timeout`` passes) and return rank 0's summary
    (``out/summary.json``; the arrays are in ``out/dryrun.npz``)."""
    os.makedirs(out, exist_ok=True)
    rdzv = os.path.join(out, "rdzv")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    threads = threads or max(1, (os.cpu_count() or 2) // (2 * world_size))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "v2ap_torch.parallel.dryrun",
            "--world-size", str(world_size), "--model-parallel",
            str(model_parallel), "--out", out, "--device", device,
            "--timeout", str(timeout), "--threads", str(threads),
            "--phases", phases]
    if backend:
        base += ["--backend", backend]
    if init:
        base += ["--init", init]
    if draws:
        base += ["--draws", draws]
    procs = []
    for r in range(world_size):
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(base + ["--rank", str(r)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed:
        logs = "".join(
            f"--- rank {r} ---\n" + open(os.path.join(out, f"rank{r}.log")
                                        ).read()[-4000:]
            for r in range(world_size))
        raise RuntimeError(f"dry run failed: {failed}\n{logs}")
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.parallel.dryrun")
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cpu (gloo), or cuda: rank r on card r modulo the "
                         "cards")
    ap.add_argument("--backend", default=None,
                    help="gloo to share one card between ranks")
    ap.add_argument("--out", default=None,
                    help="directory of the store, the logs and the outputs "
                         "(default: a new temporary one)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--threads", type=int, default=None,
                    help="torch threads per rank")
    ap.add_argument("--init", default=None,
                    help="a CFM state dict (torch.save) to start from")
    ap.add_argument("--draws", default=None,
                    help=".npz of the train step's global LossDraws")
    ap.add_argument("--phases", default="train,dropout,dpo,sample,ckpt,serve")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        try:
            _rank_main(args)
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
        return 0
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu")
    out = args.out
    if out is None:
        import tempfile
        out = tempfile.mkdtemp(prefix="v2ap_dryrun_")
    t0 = time.perf_counter()
    summary = run_dryrun(args.world_size, args.model_parallel, out,
                         device=args.device, backend=args.backend,
                         timeout=args.timeout, threads=args.threads,
                         init=args.init, draws=args.draws,
                         phases=args.phases)
    summary.update(world_size=args.world_size,
                   model_parallel=args.model_parallel,
                   data_parallel=args.world_size // args.model_parallel,
                   wall_s=time.perf_counter() - t0, out=out)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
