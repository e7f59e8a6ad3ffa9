#!/usr/bin/env python3
"""Drive the PyTorch port (``v2ap_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result line) if it fails:

  1. build   — print the card, compile ``v2ap_torch/csrc/flash_fwd.cu`` with
               nvcc for sm_90a, print the build seconds;
  2. kernels — each kernel (K1 packed, K2 4D) on the card at the main path's
               shapes against its plain PyTorch version on the same bf16
               inputs, computed in f32, K1 also with logits in softclamp's
               range; kernel / plain / library times (K1: compiled
               flex_attention, K2: scaled_dot_product_attention) and the
               card's least time for the same work (bound);
  3. small   — a small f32 configuration through the port's entry points on
               the card (kernels) and on the CPU (plain versions), same
               weights and x0: CLIP features, sampled latents and waveform
               must agree;
  4. generate — the full-width V2A slice: v2a_default() (12 layers, dim 1024,
               bf16), CLIP ViT-bigG, the full EnCodec, random weights from
               seed 0 made on the device; a 10 s clip of seeded 224x224
               uint8 frames at 25 fps through ``V2APipeline.generate`` with
               25 steps and cfg_strength 2.0, once to warm up and then
               GENERATE_RUNS times timed (median wall and stage times, the
               realtime factor). The launch counters are zeroed just before
               each timed run and read just after; K1 must run (steps-1) x
               48 times and K2 48 x (tower chunks) times in each;
  5. profile — CUDA time by kernel group and by kernel over one more
               generate, and its share of that run's wall.

The line before the last is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}. Without CUDA, or without the repo
around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
# bf16 kernel output vs the f32 plain version: |err| <= KERNEL_RTOL *
# max(1, max|ref|). Rounding the output costs half a bf16 ulp, at most
# 2^-8 |o| (K2 read 3.648e-3 at 1 <= |o| < 2, K1 1.539e-3); rounding P to
# bf16 before P.V costs at most 2^-9 max|v| spread over a row's weights.
KERNEL_RTOL = 2.0 ** -7
SOFTCLAMP_Q_GAIN = 40.0            # logits of std 40: softclamp's own range
SMALL_REL_RMS = 1e-3               # f32 card vs CPU, other summation orders
CLIP_S = 10.0
FPS = 25
GENERATE_RUNS = 5                  # timed full-width generates (median)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item())


# --------------------------------------------------------------- phase 2

def kernel_cases(torch):
    """(label, kernel id, kernel call, plain call, library call or None,
    q, k, v, mask) at the main path's shapes, bf16, from a seeded
    generator on the card. q/k/v are the strided views the path passes."""
    from v2ap_torch.ops import flash_attention as fa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # the serving bucket: 768 latents + 32 registers, 750 + 32 valid
    mask = (torch.arange(800, device=dev) < 782)[None].expand(2, 800).contiguous()
    cases = []
    for label, heads, gain in (
            ("K1 self-attn (2, 800, 16x64)", 16, 1.0),
            ("K1 roll self-attn (2, 800, 8x64)", 8, 1.0),
            ("K1 self-attn, logits std 40 (2, 800, 16x64)", 16,
             SOFTCLAMP_Q_GAIN)):
        qkv = rnd(2, 800, 3 * heads * 64)                      # fused qkv
        qkv[..., :heads * 64] *= gain       # |s| up to ~150: tanh bends
        q, k, v = qkv.chunk(3, dim=-1)
        cases.append((label, "K1", q, k, v, mask, dict(heads=heads)))
    ones = torch.ones(2, 1, dtype=torch.bool, device=dev)
    cases.append(("K1 cross-attn nk=1 (2, 800x1, 16x64)", "K1",
                  rnd(2, 800, 1024), rnd(2, 1, 1024), rnd(2, 1, 1024), ones,
                  dict(heads=16)))
    q, k, v = (rnd(64, 257, 1664).unflatten(-1, (16, 104)).transpose(1, 2)
               for _ in range(3))
    cases.append(("K2 ViT-bigG (64, 16, 257, 104)", "K2", q, k, v, None, {}))

    out = []
    for label, kid, q, k, v, m, kw in cases:
        if kid == "K1":
            h = kw["heads"]

            def run(q=q, k=k, v=v, m=m, h=h):
                return fa.flash_attention_packed(q, k, v, m, heads=h,
                                                 dim_head=64, softclamp=50.0)

            def plain(q=q, k=k, v=v, m=m, h=h):
                un = [fa._heads_view(t, h, 64) for t in (q, k, v)]
                return fa.attention_reference(*un, m, softclamp=50.0
                                              ).transpose(1, 2).flatten(2)

            def ref32(q=q, k=k, v=v, m=m, h=h):
                un = [fa._heads_view(t.float(), h, 64) for t in (q, k, v)]
                return fa.attention_reference(*un, m, softclamp=50.0
                                              ).transpose(1, 2).flatten(2)

            library = (flex_softclamp(torch, q, k, v, m, h)
                       if k.shape[1] > 1 else None)
            shape = (q.shape[0], h, q.shape[1], k.shape[1], 64)
        else:
            scale = 104 ** -0.5

            def run(q=q, k=k, v=v):
                return fa.flash_attention(q, k, v, scale=scale)

            def plain(q=q, k=k, v=v):
                return fa.attention_reference(q, k, v, scale=scale)

            def ref32(q=q, k=k, v=v):
                return fa.attention_reference(q.float(), k.float(), v.float(),
                                              scale=scale)

            def library(q=q, k=k, v=v):
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, scale=scale)

            shape = tuple(q.shape[:3]) + (k.shape[2], q.shape[3])
        out.append((label, kid, run, plain, ref32, library, shape, m))
    return out


def flex_softclamp(torch, q, k, v, mask, heads: int):
    """K1's function as one PyTorch call, a yardstick only: compiled
    ``flex_attention`` with softclamp 50 and then the mask as its score_mod.
    The mask enters as an f32 bias of 0 / -1e30 (a clamped logit added to
    -1e30 rounds to -1e30, so fully masked rows still average v); indexing
    the bool mask in the score_mod instead is many times slower.
    Returns (b, n, h*d); None where this torch lacks flex_attention."""
    try:
        from torch.nn.attention.flex_attention import flex_attention
    except ImportError:
        return None
    flex = torch.compile(flex_attention, dynamic=False)
    from v2ap_torch.ops.flash_attention import NEG_INF, _heads_view

    bias = torch.where(mask, 0.0, NEG_INF).float()

    def score_mod(s, b, h, qi, ki):
        return torch.tanh(s / 50.0) * 50.0 + bias[b, ki]

    def call():
        out = flex(*(_heads_view(t, heads, 64) for t in (q, k, v)),
                   score_mod=score_mod, scale=64 ** -0.5)
        return out.transpose(1, 2).flatten(2)

    return call


def bound(shape, elem_bytes: int, mask_bytes: int):
    """Least time on the card for one call: each input read once and the
    output written once at the HBM rate, or 4*b*h*nq*nk*d FLOP at the
    dense bf16 rate, whichever is larger."""
    b, h, nq, nk, d = shape
    nbytes = elem_bytes * (2 * b * h * nq * d + 2 * b * h * nk * d) + mask_bytes
    flops = 4.0 * b * h * nq * nk * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", flops)


def phase_kernels(torch) -> dict:
    results = {}
    for label, kid, run, plain, ref32, library, shape, mask in \
            kernel_cases(torch):
        out = run()
        ref = ref32()
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{label}: non-finite kernel output")
        ref_max = ref.abs().max().item()
        tol = KERNEL_RTOL * max(1.0, ref_max)
        err = (out.float() - ref).abs().max().item()
        status = "ok" if err <= tol else "FAIL"
        lib_err = None
        if library is not None:
            lib_err = (library().float() - ref).abs().max().item()
            if lib_err > tol:
                raise RuntimeError(f"{label}: library yardstick disagrees "
                                   f"with the plain version ({lib_err:.3e})")
        ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=5)
        lib_ms = time_ms(torch, library) if library is not None else None
        bound_ms, bound_by, flops = bound(
            shape, 2, mask.numel() if mask is not None else 0)
        log(f"  {label}: max|ref| {ref_max:.3f}, max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {status}; kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"library "
            + ("n/a" if lib_ms is None else
               f"{lib_ms:.4f} ms (max_abs_err {lib_err:.3e})")
            + f", bound {bound_ms:.4f} ms by {bound_by} "
            f"({bound_ms / ms:.1%} of bound)")
        if status != "ok":
            raise RuntimeError(f"{label}: kernel disagrees with plain version")
        entry = results.setdefault(kid, dict(cases={}, max_abs_err=0.0))
        entry["cases"][label] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return results


# --------------------------------------------------------------- phase 3

def phase_small(torch) -> None:
    """A small f32 config whose head dims (64, 104) the kernels take: the
    port on the card against the port on the CPU, same weights and x0."""
    from v2ap_torch import config as C
    from v2ap_torch.models.clip_vit import CLIPVisionConfig
    from v2ap_torch.ops.flash_attention import launch_counts, reset_launch_counts
    from v2ap_torch.pipelines.generate import V2APipeline

    base = C.v2a_default()
    cfg = base.replace(
        model=dataclasses.replace(
            base.model, dim=128, depth=2, heads=2, dim_text=128, text_heads=2,
            text_depth=2, dim_frames=128, frames_heads=2, dim_context=128,
            max_seq_len=256, dtype="float32"),
        conditioning=dataclasses.replace(base.conditioning, frame_stride=1,
                                         feature_cache=False))
    clip = CLIPVisionConfig(hidden_size=208, intermediate_size=416,
                            num_layers=2, num_heads=2, image_size=56,
                            projection_dim=128, dtype="float32")
    gpu = V2APipeline(cfg, seed=1, device="cuda", clip_config=clip)
    cpu = V2APipeline(cfg, seed=1, device="cpu", clip_config=clip)
    for a, b in ((gpu.cfm, cpu.cfm), (gpu.codec, cpu.codec),
                 (gpu.clip, cpu.clip)):
        b.load_state_dict(a.state_dict())
    rng = __import__("numpy").random.default_rng(1)
    frames = rng.integers(0, 256, (12, 56, 56, 3), dtype="uint8")
    n, n_valid = 96, 75
    reset_launch_counts()
    feats = [p.encode_video_frames_clip(None, n, frames_cache=[(frames, 1.0, 1)])[0]
             for p in (gpu, cpu)]
    x0 = torch.randn(1, n, 128, generator=torch.Generator().manual_seed(2))
    mask = torch.arange(n)[None] < n_valid
    sampler = C.SamplerConfig(steps=4, cfg_strength=2.0)
    lat, wav = [], []
    with torch.inference_mode():
        for p, f in zip((gpu, cpu), feats):
            dev = p.device
            lat.append(p.cfm.sample(
                x0.to(dev), text_embed=f[None], frames_embed=torch.zeros(
                    1, n, cfg.model.notes, device=dev),
                context=torch.zeros(1, 1, 128, device=dev),
                context_mask=torch.ones(1, 1, dtype=torch.bool, device=dev),
                mask=mask.to(dev), sampler=sampler))
            wav.append(p.codec.decode(lat[-1][:, :n_valid]))
    torch.cuda.synchronize()
    checks = [("features", feats), ("latents", lat), ("waveform", wav)]
    for name, (g, c) in checks:
        g = g.cpu()
        if not torch.isfinite(g).all():
            raise RuntimeError(f"small: non-finite {name} on the card")
        err = rel_rms(g, c)
        log(f"  small f32 {name} {tuple(g.shape)}: rel-RMS card vs CPU "
            f"{err:.2e} (tol {SMALL_REL_RMS})")
        if err > SMALL_REL_RMS:
            raise RuntimeError(f"small: {name} disagree")
    if not (launch_counts["flash_attention"] and
            launch_counts["flash_attention_packed"]):
        raise RuntimeError(f"small: kernels not launched: {launch_counts}")


# --------------------------------------------------------------- phase 4

def full_pipeline(torch):
    from v2ap_torch import config as C
    from v2ap_torch.pipelines.generate import V2APipeline

    base = C.v2a_default()
    cfg = base.replace(conditioning=dataclasses.replace(
        base.conditioning, frame_stride=1, feature_cache=False))
    t0 = time.perf_counter()
    pipe = V2APipeline(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  build full-width pipeline: {time.perf_counter() - t0:.2f} s "
        f"(CFM {sum(p.numel() for p in pipe.cfm.parameters()) / 1e6:.1f} M "
        f"params f32, ViT-bigG "
        f"{sum(p.numel() for p in pipe.clip.parameters()) / 1e6:.1f} M bf16, "
        f"EnCodec decoder "
        f"{sum(p.numel() for p in pipe.codec.parameters()) / 1e6:.1f} M f32)")
    import numpy as np
    frames = np.random.default_rng(0).integers(
        0, 256, (int(CLIP_S * FPS), 224, 224, 3), dtype=np.uint8)
    return pipe, cfg, frames


def phase_generate(torch, pipe, cfg, frames) -> dict:
    """One warm-up generate, then GENERATE_RUNS timed ones. The launch
    counters are zeroed just before each timed run and read just after it;
    every run must give finite audio of the clip's length and the expected
    counts. Reports the median wall time and each stage's median."""
    import numpy as np

    from v2ap_torch.ops.flash_attention import launch_counts, reset_launch_counts

    def gen():
        return pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                             frames_cache=[(frames, CLIP_S, 1)])

    m = cfg.model
    evals = 25 - 1
    per_eval = (m.depth + (m.depth if m.if_cross_attn else 0)
                + 2 * m.text_depth)
    chunks = math.ceil(len(frames) / 64)
    expect = {"flash_attention_packed": evals * per_eval,
              "flash_attention": pipe.clip_cfg.num_layers * chunks}

    t0 = time.perf_counter()
    gen()                                         # warm: handles, plans
    torch.cuda.synchronize()
    log(f"  warm-up generate: {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    walls, stages = [], []
    for _ in range(GENERATE_RUNS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        wav, sr = gen()
        walls.append(time.perf_counter() - t0)
        counts = dict(launch_counts)
        stages.append(pipe.last_timings)
        if wav.shape != (int(CLIP_S * sr),) or not np.isfinite(wav).all():
            raise RuntimeError(f"generate: bad waveform {wav.shape}")
        if counts != expect:
            raise RuntimeError(f"generate: launch counts {counts} != {expect}")
    wall = float(np.median(walls))
    stage_med = ", ".join(f"{k} {np.median([s[k] for s in stages]):.4f}"
                          for k in stages[0])
    log(f"  generate 10 s clip x{GENERATE_RUNS}: wall (s) "
        f"{', '.join(f'{w:.4f}' for w in walls)}; median {wall:.4f} s, "
        f"realtime factor {CLIP_S / wall:.3f}x")
    log(f"  median stages (s): {stage_med}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; waveform "
        f"{wav.shape} finite, rms "
        f"{float(np.sqrt(np.mean(wav.astype(np.float64) ** 2))):.4f}")
    log(f"  launches per run: {counts} (expected {expect})")
    return counts


# kernel-name fragments -> the group a kernel's time is reported under
PROFILE_GROUPS = (("K2 flash_fwd d104", "flash_fwd_kernel<__nv_bfloat16, 104>"),
                  ("K1 flash_fwd d64", "flash_fwd_kernel<__nv_bfloat16, 64>"),
                  ("matmul (cuBLAS)", "nvjet", "gemm", "xmma", "cutlass"),
                  ("dtype casts / copies", "copy_kernel"),
                  ("LSTM", "lstm", "LSTM", "RNN"),
                  ("convolution", "conv", "cudnn"))


def phase_profile(torch, pipe, frames) -> None:
    """CUDA kernel time over one generate, by group and by kernel, and its
    share of the profiled run's wall time. A failed generate or profiler
    fails the run; a profiler that records no device time is reported as
    not measured."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wav, _ = pipe.generate(None, steps=25, cfg_strength=2.0, seed=0,
                               frames_cache=[(frames, CLIP_S, 1)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not __import__("numpy").isfinite(wav).all():
        raise RuntimeError("profile: non-finite waveform")
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in rows)
    if not total:
        log("  profile: no device time recorded (not measured)")
        return
    log(f"  profile: {total / 1e3:.1f} ms CUDA kernel time in one generate "
        f"of {wall * 1e3:.1f} ms wall under the profiler (kernels busy "
        f"{total / 1e6 / wall:.1%} of it)")
    groups = {}
    for e in rows:
        name = next((g[0] for g in PROFILE_GROUPS
                     if any(s in e.key for s in g[1:])), "other")
        ms, n = groups.get(name, (0.0, 0))
        groups[name] = (ms + e.device_time_total / 1e3, n + e.count)
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    group {name:22s} {ms:9.2f} ms {n:7d} launches "
            f"{ms * 1e3 / total:6.1%}")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        log(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.device_time_total / total:6.1%}  {e.key[:90]}")


# ------------------------------------------------------------------ main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from v2ap_torch.ops import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: the v2ap_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"[1/5] build — card: {card_line()}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}; f32 matmul and cuDNN TF32 off")
    t0 = time.perf_counter()
    lib = fa.build_library()
    fa._library()
    log(f"  built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    log("[2/5] kernels vs plain versions (bf16 in, f32 reference)")
    kern = phase_kernels(torch)
    log("[3/5] small f32 config: card vs CPU")
    phase_small(torch)
    log("[4/5] full-width V2A generate")
    pipe, cfg, frames = full_pipeline(torch)
    counts = phase_generate(torch, pipe, cfg, frames)
    log("[5/5] profile")
    phase_profile(torch, pipe, frames)

    main_case = {"K1": "K1 self-attn (2, 800, 16x64)",
                 "K2": "K2 ViT-bigG (64, 16, 257, 104)"}
    meta = {"K1": ("flash_attention_packed",
                   "v2ap_tpu/ops/flash_attention.py:503"),
            "K2": ("flash_attention", "v2ap_tpu/ops/flash_attention.py:103")}
    entries = []
    for kid in ("K1", "K2"):
        name, replaces = meta[kid]
        c = kern[kid]["cases"][main_case[kid]]
        entries.append({
            "name": name, "route": "cuda",
            "source": "v2ap_torch/csrc/flash_fwd.cu", "replaces": replaces,
            "launches": counts[name], "max_abs_err": kern[kid]["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    log(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:                # any failed phase: no result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
