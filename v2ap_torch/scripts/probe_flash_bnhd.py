"""Probe: attention straight on the packed (b, n, h*d) layout of a fused qkv
projection ("BNHD") against the (b, h, n, d) layout and its transposes.

Counterpart of ``scripts/probe_flash_bnhd.py``. Both paths split a fused
(b, n, 3*h*d) qkv, rotate q and k and attend with softclamp 50:

  old_path: transpose q/k/v to contiguous (b, h, n, d), rotary, the 4D
            entry point ``flash_attention`` (K2's kernel), heads merged back
            (free: the kernel writes a (b, n, h, d) buffer);
  new_path: rotary with ``seq_axis=1`` on (b, n, h, d) views, then
            ``flash_bnhd`` on the packed strides, no transposes.

``flash_bnhd`` is the port of the probe's Pallas kernel P1
(``_bnhd_fwd_kernel``): the same function as K1, ``softmax(mask(softclamp(
q k^T * scale))) v`` with the softclamp before the key mask, an online
softmax with the denominator floored at 1e-20, no lse, output in q's dtype,
and a fully masked row averaging v. Its Pallas ``head_group`` unroll and
block-size search are TPU tiling, not semantics. On a CUDA tensor it
launches the forward kernel (bf16: ``v2ap_torch/csrc/flash_fwd_sm90.cu``
on the tensor cores; f32: ``flash_fwd.cu``) on the packed strides with no
lse pointer, counted under
``launch_counts["flash_bnhd"]``; on a CPU tensor it takes the plain
``attention_reference``.

    python -m v2ap_torch.scripts.probe_flash_bnhd [--batch 24] [--seq 768]
        [--heads 16] [--dim-head 64] [--reps 20] [--device cuda]

Times are CUDA-event medians over ``--reps`` calls after one warm-up call.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from v2ap_torch.ops import flash_attention as fa
from v2ap_torch.ops.rope import apply_rope
from v2ap_torch.utils.device import resolve_device


def flash_bnhd(q, k, v, kv_mask=None, *, softclamp=None, scale=None,
               heads=None, dim_head=64) -> torch.Tensor:
    """P1: attention on packed (b, n, h*d) q/k/v (any row strides, a
    contiguous last dim) with a (b, nk) key mask, None meaning all keys.
    Returns (b, nq, h*d) in q's dtype."""
    h = heads or q.shape[-1] // dim_head
    if q.shape[-1] != h * dim_head:
        raise ValueError(f"packed width {q.shape[-1]} != {h} x {dim_head}")
    scale = scale if scale is not None else dim_head ** -0.5
    qh, kh, vh = (fa._heads_view(t, h, dim_head) for t in (q, k, v))
    if not q.is_cuda:
        return fa.attention_reference(qh, kh, vh, kv_mask, softclamp=softclamp,
                                      scale=scale).transpose(1, 2).flatten(2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fa._launch(qh, kh, vh, kv_mask, fa._heads_view(out, h, dim_head),
               scale=scale, softclamp=softclamp)
    fa.count_launch("flash_bnhd")
    return out


def probe_inputs(b: int, n: int, h: int, d: int, device, seed: int = 0,
                 dtype=torch.bfloat16):
    """The probe's inputs from ``numpy.random.default_rng(seed)``, in the
    JAX script's order: the fused qkv (b, n, 3*h*d) in ``dtype``, an all-ones
    (b, n) mask and a random (n, d) rotary table in f32."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(
        np.float32)).to(device=device, dtype=dtype)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    rot = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                           ).to(device)
    return qkv, mask, rot


def make_paths(b: int, n: int, h: int, d: int, rot: torch.Tensor,
               mask: torch.Tensor, softclamp: float = 50.0):
    """(old_path, new_path), each mapping the fused qkv to (b, n, h*d)."""

    def old_path(qkv):
        q, k, v = qkv.chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2).contiguous()
                   for t in (q, k, v))
        q, k = apply_rope(q, rot), apply_rope(k, rot)
        o = fa.flash_attention(q, k, v, mask, softclamp=softclamp)
        return o.transpose(1, 2).reshape(b, n, h * d)

    def new_path(qkv):
        q, k, v = qkv.chunk(3, dim=-1)
        q = apply_rope(q.reshape(b, n, h, d), rot, seq_axis=1).flatten(2)
        k = apply_rope(k.reshape(b, n, h, d), rot, seq_axis=1).flatten(2)
        return flash_bnhd(q, k, v, mask, softclamp=softclamp, heads=h,
                          dim_head=d)

    return old_path, new_path


def bench(fn, args, reps: int = 20):
    """(median, min, max) ms of ``fn(*args)`` over ``reps`` calls after one
    warm-up call: CUDA events around each call on a card, the host clock on
    the CPU."""
    fn(*args)
    ts = []
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.asarray(ts)
    return float(np.median(ts)), float(ts.min()), float(ts.max())


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).pow(2).mean().sqrt()
                  / (b.pow(2).mean().sqrt() + 1e-9)).item())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--seq", type=int, default=768)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--dim-head", type=int, default=64)
    ap.add_argument("--head-group", type=int, default=0,
                    help="the JAX script's TPU head unroll; the CUDA kernel "
                         "runs one head per block, so it is only reported")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    b, n, h, d = args.batch, args.seq, args.heads, args.dim_head
    device = resolve_device(args.device)
    qkv, mask, rot = probe_inputs(b, n, h, d, device)
    old_path, new_path = make_paths(b, n, h, d, rot, mask)
    with torch.inference_mode():
        rel = rel_rms(new_path(qkv), old_path(qkv))
        print(f"parity old vs new rel-rms: {rel:.2e}")
        result = {"rel_rms": rel}
        for key, name, fn in (
                ("old_ms", "old bhnd+transposes", old_path),
                ("new_ms", f"new bnhd hg={args.head_group or h}", new_path)):
            med, lo, hi = bench(fn, (qkv,), args.reps)
            print(f"{name:24s} {med:8.3f} ms  [{lo:.3f}, {hi:.3f}]")
            result[key] = med
    return result


if __name__ == "__main__":
    main()
