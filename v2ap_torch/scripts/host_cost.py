"""Host microseconds of one ``flash_attention_packed`` call at the serving
self-attention's shape, (2, 800, 16x64) with softclamp 50 and 782 of 800
keys attending, for one or more checkouts side by side in one process.

    python -m v2ap_torch.scripts.host_cost [ROOT ...] [--rounds 6]
        [--calls 200] [--dtype bf16 f32]

Each ROOT is a checkout of this repo. Its ``v2ap_torch/ops/flash_attention.py``
is loaded as a module of its own (the module imports nothing else of its
package) and builds its kernels into ``ROOT/build/v2ap_torch``. Without a
ROOT, this checkout. A sample is the host wall time of ``--calls`` calls
enqueued with no synchronise between them, over the calls. The rounds take
the checkouts in turn, forwards in even rounds and backwards in odd ones
(A B, B A, ...), so a drift of the host's speed falls on both. Every sample
is printed, then each checkout's median. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import time
from pathlib import Path

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def load(root: Path, index: int):
    """``root``'s flash_attention module, under a name of its own."""
    path = root / "v2ap_torch" / "ops" / "flash_attention.py"
    spec = importlib.util.spec_from_file_location(f"_flash_{index}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._library()               # build and load before timing
    return module


def packed_call(fa, dtype):
    """One K1 call at (2, 800, 16x64) on the chunks of a fused qkv."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = torch.randn(2, 800, 3072, generator=gen, device="cuda").to(
        dtype).chunk(3, dim=-1)
    mask = (torch.arange(800, device="cuda") < 782)[None].expand(
        2, 800).contiguous()
    return lambda: fa.flash_attention_packed(q, k, v, mask, heads=16,
                                             dim_head=64, softclamp=50.0)


def sample_us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path,
                    default=[Path(__file__).resolve().parents[2]])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--dtype", nargs="+", choices=sorted(DTYPES),
                    default=["bf16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_cost needs a CUDA card")
    names = [str(r) for r in args.roots]
    calls = {}
    for i, root in enumerate(args.roots):
        fa = load(root.resolve(), i)
        for dt in args.dtype:
            fn = calls[names[i], dt] = packed_call(fa, DTYPES[dt])
            for _ in range(3):                      # warm up
                fn()
    samples = {key: [] for key in calls}
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        for name in order:
            for dt in args.dtype:
                us = sample_us(calls[name, dt], args.calls)
                samples[name, dt].append(us)
                print(f"round {r} {name} {dt}: {us:.2f} us", flush=True)
    for (name, dt), xs in samples.items():
        print(f"{name} {dt}: median {statistics.median(xs):.2f} us of "
              f"{len(xs)} samples x {args.calls} calls "
              f"({', '.join(f'{x:.2f}' for x in xs)})")


if __name__ == "__main__":
    main()
