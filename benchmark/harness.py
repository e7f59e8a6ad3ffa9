"""One run of one cell: set-up, a closed-loop window of timed calls, the
comparison with the reference, and the result line.

Everything a cell is made of is found by name:

  BENCHMARK.json            the cells, metrics and bounds
  <config's "file">         the configuration (``benchmark/configs``); its
                            ``"family"`` names the family, "v2ap" without
                            the key
  benchmark/families/<f>.py the family: what runs a configuration of that
                            kind of model (below)
  benchmark/traffic/<t>.json   the traffic mix, read by the family's
                            ``Traffic``; every mix has ``warmup`` (calls in
                            set-up) and ``trace_requests`` (calls the
                            ``--trace 1`` run profiles)
  benchmark/metrics/<m>.py  one reader per metric: ``read(run)`` returns
                            the number, or None where it finds nothing
  benchmark/limits/<cell>.json the limits of the correctness check

so a cell, a configuration, a metric or a kind of model is added by adding
files and entries. The run's record (``Run``) is what the readers see.

A family module (loaded by path from the run's root, as the readers are)
gives, under these names:

  build(config, device, control=False)
        the system under test, with ``load(weights)`` and ``kept`` (what
        the check needs of the last call beyond its answer, or None);
        ``control`` computes one precision below the configuration's
        (``benchmark/control.py --control``)
  weights(config, traffic, seed, device)
        the weights drawn from ``seed`` (``weights_seed`` of the run's),
        the same for the same seed
  Traffic(params, seed)
        the traffic: ``kind``, ``clips_per_call``, ``make_pool(device)``,
        ``request(i, pool)`` (call ``i``, the same for the same seed) and
        ``checked(completed)`` (the indices the reference judges)
  prepare(system, request, kind)
        untimed: what a call needs made before the clock starts
  serve(system, request, kind, prepared)
        the timed call: (waves, roll or None, timings); only this runs
        between the window's two clock reads
  reference_readings(cell, run, seed, device)
        after the window, with the system freed: the numbers
        ``check.judge`` holds against the cell's limits, the run's answers
        against the plain reference's from the same inputs and weights
  request_flops(config, traffic)
        model operations of one call, by part (``Run.flops``)
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import check
from benchmark.trace import traced

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
    family: types.ModuleType    # benchmark/families/<config's family>.py


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
                check.load_limits(root, workload),
                family(config.get("family", "v2ap"), root))


def _load(kind: str, name: str, root: Path) -> types.ModuleType:
    """``benchmark/<kind>/<name>.py`` of ``root``, loaded by path and
    registered in ``sys.modules``, as its dataclasses need."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def family(name: str, root: Path = ROOT) -> types.ModuleType:
    """The family module ``benchmark/families/<name>.py``."""
    return _load("families", name, root)


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return _load("metrics", name, root).read


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
    kept: Optional[dict] = None     # the system's ``kept`` after the call


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
        return self.cell.family.request_flops(self.cell.config,
                                              self.cell.traffic)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weights_seed(seed: int) -> int:
    """The seed the weights are drawn from, derived from the run's."""
    return int(np.random.default_rng([int(seed), 0]).integers(2 ** 62))


def setup(c: Cell, seed: int, device):
    """Build the system, load the seeded weights, make the pool and warm
    every shape of the cell's traffic. Returns (system, traffic, pool,
    seconds)."""
    fam = c.family
    t0 = time.perf_counter()
    marks = []
    system = fam.build(c.config, device)
    marks.append(("pipeline", time.perf_counter()))
    w = fam.weights(c.config, c.traffic, weights_seed(seed), device)
    system.load(w)
    del w
    marks.append(("weights", time.perf_counter()))
    traffic = fam.Traffic(c.traffic, seed)
    pool = traffic.make_pool(device)
    marks.append(("pool", time.perf_counter()))
    for i in range(c.traffic["warmup"]):
        req = traffic.request(i, pool)
        fam.serve(system, req, traffic.kind,
                  fam.prepare(system, req, traffic.kind))
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
    kind, fam = traffic.kind, run.cell.family

    def one(i, traced=False):
        req = traffic.request(i, pool)
        prepared = fam.prepare(system, req, kind)
        t0 = time.perf_counter()
        try:
            waves, roll, timings = fam.serve(system, req, kind, prepared)
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
    readings = c.family.reference_readings(c, run, seed, device)
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
