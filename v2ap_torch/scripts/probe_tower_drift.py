"""Probe: CLIP ViT-bigG conditioning-feature drift across serving
precisions, f32 against bf16 and the int8 variants.

Counterpart of ``scripts/probe_tower_drift.py``. One seeded tower
(``clip_vit_bigg()``, seed 3) runs the same frames in each variant:

  f32              float32 compute (the reference numerics)
  bf16             bf16 compute, float32 parameters and LayerNorms
  int8             bf16 compute, AQT int8 on every ``Linear``
  int8_mlp         int8 on the MLP ``Linear``s only
  int8_skip_last4  int8 everywhere but the last 4 encoder layers (the
                   projection, whose name is not ``projection``, stays int8,
                   as in JAX)

and prints one JSON line: each variant's rel-RMS drift of the 1280-d
projected features against f32, its int8 layer count, and its tower wall
(median of ``--reps`` after one warm-up, synchronised; the warm-up alone
with ``--reps 0``).

    python -m v2ap_torch.scripts.probe_tower_drift [--frames 64] [--reps 3]
        [--device cuda] [--layers N]

``--layers`` cuts the depth (a CPU-sized run); the widths stay bigG's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m v2ap_torch.scripts.probe_tower_drift")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="encoder depth (default: bigG's 48)")
    args = ap.parse_args(argv)

    from v2ap_torch.models.clip_vit import (CLIP_MEAN, CLIP_STD,
                                            CLIPVisionModel, clip_vit_bigg,
                                            device_normalize)
    from v2ap_torch.ops.layers import Linear
    from v2ap_torch.utils.device import resolve_device, seeded_init

    device = resolve_device(args.device)
    ccfg = clip_vit_bigg()
    if args.layers:
        ccfg = dataclasses.replace(ccfg, num_layers=args.layers)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (224, 224, 3), dtype=np.uint8)
    px = np.stack([np.roll(base, 3 * i, axis=1) for i in range(args.frames)])
    px = device_normalize(torch.from_numpy(px).to(device), CLIP_MEAN, CLIP_STD)

    def build(dtype: str):
        with seeded_init(3, device):
            tower = CLIPVisionModel(dataclasses.replace(ccfg, dtype=dtype),
                                    device=device)
        return tower.eval().requires_grad_(False)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def run(tower):
        t0 = time.perf_counter()
        out = tower(px).float()
        sync()
        times = [time.perf_counter() - t0]
        for _ in range(args.reps):
            t0 = time.perf_counter()
            tower(px)
            sync()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times[-max(args.reps, 1):]))

    result: dict = {}
    tower = build("float32")
    f32, result["f32_s"] = run(tower)
    del tower
    denom = float(f32.pow(2).mean().sqrt())

    def drift(feats) -> float:
        return round(float((feats - f32).pow(2).mean().sqrt()) / denom, 5)

    tower = build("bfloat16")

    def set_int8(predicate) -> int:
        n = 0
        for name, mod in tower.named_modules():
            if isinstance(mod, Linear):
                mod.int8 = bool(predicate(tuple(name.split("."))))
                n += int(mod.int8)
        return n

    feats, result["bf16_s"] = run(tower)
    result["bf16_drift"] = drift(feats)
    last4 = {str(i) for i in range(ccfg.num_layers - 4, ccfg.num_layers)}
    for label, pred in (
            ("int8", lambda p: True),
            ("int8_mlp", lambda p: "mlp" in p),
            ("int8_skip_last4",
             lambda p: not (set(p) & last4) and "projection" not in p)):
        n = set_int8(pred)
        feats, result[f"{label}_s"] = run(tower)
        result[f"{label}_drift"] = drift(feats)
        result[f"{label}_linears"] = n
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
