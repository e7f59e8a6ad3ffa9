"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --sound 11 12 13 \
        --control 21 22 23 [--fp8ref 31 32 33] [--fault step 41 42 43]

For each seed, in one process, all through the cell's family
(``benchmark/families/<family>.py``): the system loads that seed's
weights and serves ``checked`` calls of the seed's traffic (after the
warm-up calls), and the family's plain reference judges them as a run
does. "sound" runs the system as the configuration states; "control"
builds it with ``control=True``, one precision below the configuration's
(v2ap: the port's own int8 product in every ``Linear`` of the towers, T5
and the flow model, below the configuration's bf16). The other two modes
run v2ap cells only: "fp8ref" puts the reference itself, computed one
precision below the configuration (``reference.nn.one_precision_below``:
every floating-point product's inputs rounded to fp8 e4m3, the products a
configuration states in int8 computed in int4), in the pipeline's place,
and under int8 towers keeps of its towers what the check compares of the
program's (``benchmark/kept.py``); "fault NAME" runs the
configured path with one of ``benchmark/faults.py``'s faults planted
(``--fault`` may be repeated).
One JSON line a seed: mode, seed, and the numbers ``benchmark/check.py``
compares. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "benchmark"]


def readings(workload: str, seeds, *, int8: bool, device="cuda",
             root: Path = ROOT):
    """Yield (seed, readings) for each seed, one system for all, built and
    fed through the cell's family."""
    import torch

    from benchmark import harness

    c = harness.cell(workload, root)
    fam = c.family
    device = torch.device(device)
    system = fam.build(c.config, device, control=int8)
    for seed in seeds:
        system.load(fam.weights(c.config, c.traffic,
                                harness.weights_seed(seed), device))
        traffic = fam.Traffic(c.traffic, seed)
        pool = traffic.make_pool(device)
        run = harness.Run(c)
        first = c.traffic["warmup"]
        for i in range(first):
            req = traffic.request(i, pool)
            fam.serve(system, req, traffic.kind,
                      fam.prepare(system, req, traffic.kind))
        for i in range(first, first + c.traffic["checked"]):
            req = traffic.request(i, pool)
            waves, roll, timings = fam.serve(
                system, req, traffic.kind,
                fam.prepare(system, req, traffic.kind))
            run.records.append(harness.Record(i, req, 0.0,
                                              traffic.clips_per_call,
                                              timings, waves, roll,
                                              kept=system.kept))
        del pool
        gc.collect()
        yield seed, fam.reference_readings(c, run, seed, device)


def fp8_readings(workload: str, seeds, device="cuda", root: Path = ROOT):
    """Yield (seed, readings) of the reference computed one precision
    below the configuration, judged as the pipeline's answers are."""
    import numpy as np
    import torch

    from benchmark import harness, kept
    from benchmark.reference import pipeline as reference
    from benchmark.reference.nn import one_precision_below

    c = harness.cell(workload, root)
    fam = c.family
    device = torch.device(device)
    for seed in seeds:
        traffic = fam.Traffic(c.traffic, seed)
        pool = traffic.make_pool(device)
        w = fam.weights(c.config, c.traffic, harness.weights_seed(seed),
                        device)
        run = harness.Run(c)
        first = c.traffic["warmup"]
        for i in range(first + c.traffic["checked"]):
            req = traffic.request(i, pool)    # the pipeline's request stream
            if i < first:
                continue
            clips = req["frames"] if traffic.kind == "batch" \
                else [req["frames"]]
            found = feats = None
            with one_precision_below():
                if c.config["quantize_towers"]:
                    found = kept.empty()
                    per_clip = reference.tower_features(
                        c.config, w, [(f, req["duration"]) for f in clips],
                        device,
                        lambda name, model: kept.keep(model, name,
                                                      lambda: found))
                    feats = [reference.join_towers(c.config, f)
                             for f in per_clip]
                if traffic.kind == "batch":
                    waves = reference.batch(c.config, w, req, device, feats)
                    roll = None
                else:
                    wave, roll = reference.single(
                        c.config, w, req, device,
                        None if feats is None else feats[0])
                    waves = wave[None]
            run.records.append(harness.Record(
                i, req, 0.0, traffic.clips_per_call, {}, waves,
                None if roll is None else torch.from_numpy(np.asarray(roll)),
                kept=found))
        del w, pool
        gc.collect()
        yield seed, fam.reference_readings(c, run, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fp8ref", type=int, nargs="*", default=[])
    ap.add_argument("--fault", nargs="+", action="append", default=[],
                    metavar="NAME SEED", help="a fault's name, then seeds")
    args = ap.parse_args(argv)
    import torch

    from benchmark import faults, harness

    family = harness.cell(args.workload).config.get("family", "v2ap")
    if (args.fp8ref or args.fault) and family != "v2ap":
        # both put the v2ap family's own reference or faults in the
        # program's place
        print(f"--fp8ref and --fault run only cells of the v2ap family; "
              f"{args.workload} is of the family {family!r}",
              file=sys.stderr)
        return 2

    for mode, seeds in (("sound", args.sound), ("control", args.control)):
        if seeds:
            for seed, r in readings(args.workload, seeds,
                                    int8=mode == "control"):
                print(json.dumps({"workload": args.workload, "mode": mode,
                                  "seed": seed, **r}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    for name, *seeds in args.fault:
        with faults.planted(name):
            for seed, r in readings(args.workload, map(int, seeds),
                                    int8=False):
                print(json.dumps({"workload": args.workload,
                                  "mode": f"fault:{name}", "seed": seed,
                                  **r}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed, r in fp8_readings(args.workload, args.fp8ref):
        print(json.dumps({"workload": args.workload, "mode": "fp8ref",
                          "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
