"""One run of one cell: set-up, a closed-loop window of timed calls, the
comparison with the reference, and the result line.

Everything a cell is made of is found by name:

  BENCHMARK.json            the cells, metrics and bounds
  <config's "file">         the configuration (``benchmark/configs``)
  benchmark/traffic/<t>.json   the traffic mix (``benchmark.traffic``)
  benchmark/metrics/<m>.py  one reader per metric: ``read(run)`` returns
                            the number, or None where it finds nothing
  benchmark/limits/<cell>.json the limits of the correctness check

so a cell, a configuration or a metric is added by adding files and
entries. The run's record (``Run``) is what the readers see.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import check, counts, weights
from benchmark.reference import pipeline as reference
from benchmark.reference.nn import int8_linear
from benchmark.system import System
from benchmark.trace import traced
from benchmark.traffic import Traffic

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "v2ap_tpu")


@dataclass
class Cell:
    name: str
    config: dict            # the configuration file's dict
    traffic: dict           # the traffic file's dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    spec = load_benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{entry['traffic']}.json") \
            as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(workload, config, traffic, e2e, layer,
                check.load_limits(root, workload))


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Record:
    index: int
    request: dict
    latency_s: float
    clips: int
    timings: dict
    waves: Optional[np.ndarray]
    roll: Optional[torch.Tensor]
    traced: bool = False            # in the traced segment, not the window
    kept: Optional[dict] = None     # System.kept of the call


@dataclass
class Run:
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    records: list = field(default_factory=list)
    failed: int = 0
    trace: object = None            # benchmark.trace.Trace
    traced_calls: int = 0
    memory_peak_bytes: int = 0

    def window_records(self) -> list:
        return [r for r in self.records if not r.traced]

    def flops(self) -> dict:
        return counts.request_flops(self.cell.config, self.cell.traffic)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weights_seed(seed: int) -> int:
    """The seed the weights are drawn from, derived from the run's."""
    return int(np.random.default_rng([int(seed), 0]).integers(2 ** 62))


def setup(c: Cell, seed: int, device):
    """Build the pipeline, load the seeded weights, make the clip pool and
    warm every shape of the cell's traffic. Returns (system, traffic,
    pool, seconds)."""
    t0 = time.perf_counter()
    marks = []
    system = System(c.config, device)
    marks.append(("pipeline", time.perf_counter()))
    w = weights.make(c.config, weights_seed(seed), device,
                     with_t5=c.traffic["prompt_words"][1] > 0)
    system.load(w)
    del w
    marks.append(("weights", time.perf_counter()))
    traffic = Traffic(c.traffic, seed)
    pool = traffic.make_pool(device)
    marks.append(("pool", time.perf_counter()))
    for i in range(c.traffic["warmup"]):
        req = traffic.request(i, pool)
        system.serve(req, traffic.kind,
                     system.x0(req) if traffic.kind == "batch" else None)
        _sync(device)
        marks.append((f"warm-up {i}", time.perf_counter()))
    last = t0
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - last:.3f}")
        last = t
    print("set-up: " + ", ".join(parts) + " s", file=sys.stderr)
    return system, traffic, pool, time.perf_counter() - t0


def window(system, traffic, pool, seconds: float, device, run: Run,
           first: int, trace_calls: int = 0) -> None:
    """The closed loop: one call at a time until ``seconds`` have passed,
    every call ending inside the window; then ``trace_calls`` more under
    the profiler (the traced segment, outside the window's time)."""
    kind = traffic.kind

    def one(i, traced=False):
        req = traffic.request(i, pool)
        x0 = system.x0(req) if kind == "batch" else None
        t0 = time.perf_counter()
        try:
            waves, roll, timings = system.serve(req, kind, x0)
        except Exception as exc:           # counted, and reported at the end
            run.failed += 1
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            waves, roll, timings = None, None, {}
        run.records.append(Record(i, req, time.perf_counter() - t0,
                                  traffic.clips_per_call, timings, waves,
                                  roll, traced, system.kept))

    i = first
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        one(i)
        i += 1
    run.window_s = time.perf_counter() - start
    if trace_calls:
        with traced(lambda: _sync(device)) as holder:
            for _ in range(trace_calls):
                one(i, traced=True)
                i += 1
        run.trace, run.traced_calls = holder[0], trace_calls


def _clip_features(cfg: dict, kept: dict, clips: list) -> list:
    """The program's features of a call (``kept``'s chunks, clip after
    clip), split by clip: per clip, tower name -> (frames, width); None
    where the towers encoded another number of frames."""
    sizes = [len(f[::cfg["conditioning"]["frame_stride"]]) for f in clips]
    per_tower = {name: torch.cat(chunks)
                 for name, chunks in kept["features"].items()}
    if any(len(t) != sum(sizes) for t in per_tower.values()):
        return None
    per_tower = {name: torch.split(t, sizes) for name, t in per_tower.items()}
    return [{name: parts[i] for name, parts in per_tower.items()}
            for i in range(len(clips))]


def layer_gap(cfg: dict, w: dict, kept: dict) -> float:
    """The kept int8 layers of a call against AQT's int8 product in the
    tower's compute dtype on the same input rows: the largest row gap."""
    gap = 0.0
    for (tower, name), pairs in kept["layers"].items():
        state = w["towers"][tower]
        weight = state[f"{name}.weight"].float()
        bias = state.get(f"{name}.bias")
        dtype = getattr(torch, cfg["towers"][tower]["dtype"])
        for x, y in pairs:
            ref = int8_linear(x.float(), weight,
                              None if bias is None else bias.float(), dtype)
            gap = max(gap, check.row_gap(y.float().cpu().numpy(),
                                         ref.cpu().numpy()))
    return gap


def reference_readings(c: Cell, run: Run, seed: int, device) -> dict:
    """The program's answers held against the reference: the checked
    requests (drawn from the seed) of the completed ones. Under int8
    towers the check goes in stages: ``layer_gap`` holds a few of the
    towers' int8 layers on their own inputs, ``feature_gap`` the towers'
    features against the reference towers', and the waveform is held
    against the reference's sampler and decoder run from the program's own
    features."""
    traffic = Traffic(c.traffic, seed)
    done = [r for r in run.records if r.waves is not None]
    w = weights.make(c.config, weights_seed(seed), device,
                     with_t5=c.traffic["prompt_words"][1] > 0)
    staged = c.config["quantize_towers"]
    readings = {"wave_gap": 0.0}
    if staged:
        readings["feature_gap"] = readings["layer_gap"] = 0.0
    if c.traffic["piano"]:
        readings["roll_gap"] = 0.0
    for k in traffic.checked(len(done)):
        rec = done[k]
        req = rec.request
        clips = req["frames"] if traffic.kind == "batch" else [req["frames"]]
        feats = None
        if staged:
            program = _clip_features(c.config, rec.kept, clips)
            if program is None:
                readings = {k: float("inf") for k in readings}
                break
            ref = reference.tower_features(
                c.config, w, [(f, req["duration"]) for f in clips], device)
            for p, r in zip(program, ref):
                for name in r:
                    readings["feature_gap"] = max(
                        readings["feature_gap"],
                        check.row_gap(p[name].float().cpu().numpy(),
                                      r[name].cpu().numpy()))
            readings["layer_gap"] = max(readings["layer_gap"],
                                        layer_gap(c.config, w, rec.kept))
            feats = [reference.join_towers(c.config, p) for p in program]
        if traffic.kind == "batch":
            ref_waves = reference.batch(c.config, w, req, device, feats)
            ref_roll = None
        else:
            ref_wave, ref_roll = reference.single(
                c.config, w, req, device, None if feats is None else feats[0])
            ref_waves = ref_wave[None]
        for prog, ref in zip(rec.waves, ref_waves):
            readings["wave_gap"] = max(readings["wave_gap"],
                                       check.rel_gap(prog, ref))
        if ref_roll is not None:
            roll = rec.roll.float().cpu().numpy()
            readings["roll_gap"] = max(readings["roll_gap"],
                                       check.rel_gap(roll, ref_roll))
    del w
    if not done:
        readings = {k: float("inf") for k in readings}
    return readings


def profiler_cost_pct(run: Run):
    """How much longer a call took under the profiler than in the window:
    100 x (traced mean latency / window mean latency - 1)."""
    window = run.window_records()
    traced_ = [r.latency_s for r in run.records if r.traced]
    if not window or not traced_:
        return None
    return 100.0 * (sum(traced_) / len(traced_)
                    / (sum(r.latency_s for r in window) / len(window)) - 1.0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT) -> dict:
    """One run; returns the result line's object."""
    device = torch.device(device)
    c = cell(workload, root)
    run = Run(c)
    system, traffic, pool, run.setup_s = setup(c, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window(system, traffic, pool, seconds, device, run,
           first=c.traffic["warmup"],
           trace_calls=c.traffic["trace_requests"] if trace else 0)
    _sync(device)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    del system, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = reference_readings(c, run, seed, device)
    print(f"{workload}: set-up {run.setup_s:.3f} s, {len(run.records)} calls "
          f"in {run.window_s:.3f} s, reference {time.perf_counter() - t0:.3f}"
          f" s, peak {run.memory_peak_bytes / 2**30:.2f} GiB; latencies "
          + " ".join(f"{r.latency_s:.4f}" for r in run.records),
          file=sys.stderr)
    if trace and run.trace is not None:
        cost = profiler_cost_pct(run)
        print(f"profiler: traced window {run.trace.window_s:.4f} s for "
              f"{run.traced_calls} calls, "
              + ("" if cost is None else f"{cost:+.2f} % a call against the"
                 " window's mean"), file=sys.stderr)
    if trace and device.type == "cuda" and not run.trace.device_ops:
        raise RuntimeError("the profiler recorded no device operation")
    correct, checks = check.judge(readings, c.limits)
    correct = correct and run.failed == 0
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = reader(m["name"], root)(run) if run.records else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(correct),
           "attempted": sum(r.clips for r in run.records),
           "failed": run.failed * traffic.clips_per_call,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks
    return out
