"""The harness on the CPU at miniature sizes: cells, configurations and
metrics found from files; a cell made of new files runs, a cell of a new
family too; the window's statistics count a stall; planted faults in the
timed path make ``correct`` false.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import inspect
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, faults, harness
from benchmark.tests.tiny import make_root

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345


def test_cells_configs_and_metrics_come_from_files():
    spec = harness.load_benchmark(REPO)
    for w in spec["workloads"]:
        c = harness.cell(w["name"], REPO)
        assert c.config["name"] == w["config"]
        assert c.traffic["kind"] in ("single", "batch")
        assert set(c.limits) >= {"wave_gap"}
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(harness.reader(m["name"], REPO))
    for m in spec["per_layer"]:
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def test_new_cell_from_files_runs_on_cpu(root):
    # a metric that exists only as a new file and a new entry
    (root / "benchmark" / "metrics" / "calls.tiny.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "calls.tiny", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "pipeline",
        "moves": "clip_latency_p50_s", "workloads": ["tiny.v2a"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell("tiny.v2a", SEED, 0.5, False, "cpu", root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"clip_latency_p50_s",
                                   "clip_latency_p90_s", "setup_s"}
    assert out["checks"]["wave_gap"]["value"] < 1e-4
    traced = harness.run_cell("tiny.v2a", SEED + 1, 0.2, True, "cpu", root)
    assert traced["correct"]
    assert traced["metrics"]["calls.tiny"]["value"] >= 2.0
    assert "sample_s.single" in traced["metrics"]


@pytest.mark.parametrize("cell", ["tiny.v2p", "tiny.batch", "tiny-mixed.v2a",
                                  "tiny-int8.v2a", "tiny-int8.batch"])
def test_each_kind_of_cell_is_correct_on_cpu(root, cell):
    out = harness.run_cell(cell, SEED + 2, 0.1, False, "cpu", root)
    assert out["correct"], out["checks"]
    for c in out["checks"].values():
        assert c["value"] < 1e-4


def _run(records, window_s=10.0, clip_s=10.0):
    cell = types.SimpleNamespace(traffic={"clip_s": clip_s})
    recs = [harness.Record(i, {}, lat, clips, {}, np.zeros(1), None)
            for i, (lat, clips) in enumerate(records)]
    return harness.Run(cell, window_s=window_s, records=recs)


def test_window_statistics_count_a_planted_stall():
    p50, p90 = (harness.reader(n, REPO) for n in
                ("clip_latency_p50_s", "clip_latency_p90_s"))
    rate = harness.reader("audio_s_per_s", REPO)
    steady = _run([(1.0, 8)] * 20, window_s=20.0)
    stalled = _run([(1.0, 8)] * 17 + [(6.0, 8)] * 3, window_s=35.0)
    assert p50(steady) == p50(stalled) == 1.0
    assert p90(steady) == 1.0 and p90(stalled) == 6.0
    assert rate(steady) == pytest.approx(160 * 10 / 20.0)
    # the stall's time stays in the window: the rate falls with it
    assert rate(stalled) == pytest.approx(160 * 10 / 35.0)


def test_shares_of_the_chip_divide_by_the_untraced_window():
    mfu, idle, stage = (harness.reader(n, REPO) for n in
                        ("mfu.single", "idle_pct.single", "sample_s.single"))
    run = _run([(1.0, 1)] * 10, window_s=10.0)
    for r in run.records:
        r.timings = {"sample_s": 0.5}
    # two calls under the profiler, each 1.5 s long with 0.8 s of device work
    for i in range(2):
        run.records.append(harness.Record(10 + i, {}, 1.5, 1,
                                          {"sample_s": 0.9}, np.zeros(1),
                                          None, traced=True))
    run.trace = types.SimpleNamespace(device_ops=[("k", 0.0, 1.6e6)],
                                      busy_s=lambda: 1.6, window_s=3.0)
    run.traced_calls = 2
    run.flops = lambda: {"cfm": 0.5 * 989e12}
    # 10 calls of 0.5 peak-seconds each over the 10 s window
    assert mfu(run) == pytest.approx(50.0)
    # 0.8 device-seconds a call over the window's 1 s a call, not the
    # profiled 1.5 s
    assert idle(run) == pytest.approx(20.0)
    assert stage(run) == 0.5
    assert harness.profiler_cost_pct(run) == pytest.approx(50.0)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.v2a", "answer"),
    ("tiny.v2a", "step"),
    ("tiny.v2a", "step-mid"),
    ("tiny.batch", "half-batch"),
    ("tiny.batch", "step"),
    ("tiny.v2p", "roll"),
    ("tiny-int8.v2a", "int8-per-tensor"),
    ("tiny-int8.v2a", "bf16-towers"),
    ("tiny-int8.v2a", "step"),
    ("tiny-int8.batch", "int8-per-tensor"),
    ("tiny-int8.batch", "half-batch"),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = harness.run_cell(cell, SEED + 3, 0.1, False, "cpu", root)
    assert not out["correct"]


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_a_planted_fault_is_undone(name):
    import v2ap_torch.models.cfm as cfm
    import v2ap_torch.ops.layers as layers
    from benchmark.system import System

    def patched():
        return (System.serve, cfm.euler_integrate,
                cfm.CFM.encode_frames, layers.int8_linear)

    before = patched()
    with faults.planted(name):
        during = patched()
    assert during != before
    assert patched() == before


def test_a_fault_in_the_towers_shows_in_their_own_numbers(root,
                                                          monkeypatch):
    """Under int8 towers the waveform's reference starts from the program's
    features, so a tower that computes too coarsely has to fail
    ``layer_gap`` and ``feature_gap`` themselves."""
    faults.FAULTS["int8-per-tensor"](monkeypatch.setattr)
    checks = harness.run_cell("tiny-int8.v2a", SEED + 4, 0.1, False, "cpu",
                              root)["checks"]
    assert checks["layer_gap"]["value"] > checks["layer_gap"]["limit"]
    assert checks["feature_gap"]["value"] > checks["feature_gap"]["limit"]


TOY_FAMILY = '''"""A toy family: a seeded float32 linear map served eagerly, held
against its float64 reference."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import check, harness

SCALE = 1.0


@dataclasses.dataclass
class System:
    dtype: torch.dtype
    w: torch.Tensor | None = None
    kept: None = None

    def load(self, weights):
        self.w = weights.to(self.dtype)


def build(config, device, control=False):
    return System(torch.bfloat16 if control else torch.float32)


def weights(config, traffic, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    n = config["width"]
    return torch.randn(n, n, generator=gen, device=device) / n ** 0.5


class Traffic:
    kind, clips_per_call = "single", 1

    def __init__(self, params, seed):
        self.p, self.seed = params, int(seed)

    def make_pool(self, device):
        gen = torch.Generator(device=device).manual_seed(self.seed)
        return [torch.randn(self.p["rows"], self.p["width"], generator=gen,
                            device=device) for _ in range(self.p["pool"])]

    def request(self, i, pool):
        return {"x": pool[i % len(pool)]}

    def checked(self, completed):
        return range(min(self.p["checked"], completed))


def prepare(system, request, kind):
    return None


def serve(system, request, kind, prepared):
    y = request["x"].to(system.dtype) @ system.w.T * SCALE
    return y.float().cpu().numpy()[None], None, {}


def reference_readings(cell, run, seed, device):
    done = [r for r in run.records if r.waves is not None]
    w = weights(cell.config, cell.traffic, harness.weights_seed(seed),
                device).double()
    gap = 0.0 if done else float("inf")
    for k in Traffic(cell.traffic, seed).checked(len(done)):
        ref = done[k].request["x"].double() @ w.T
        gap = max(gap, check.rel_gap(done[k].waves[0], ref.cpu().numpy()))
    return {"wave_gap": gap}


def request_flops(config, traffic):
    return {"map": 2.0 * traffic["rows"] * config["width"] ** 2}
'''


@pytest.fixture(scope="module")
def toy_root(root):
    """``root`` with two cells of families that exist only as files in it:
    ``toy.map`` and ``toy_wrong.map``, whose ``serve`` scales its answer by
    1.05."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    p50 = next(m for m in spec["end_to_end"]
               if m["name"] == "clip_latency_p50_s")
    (bench / "traffic" / "toy.json").write_text(json.dumps(
        {"rows": 32, "width": 64, "pool": 2, "checked": 2, "warmup": 1,
         "trace_requests": 1}))
    for name, scale in (("toy", "1.0"), ("toy_wrong", "1.05")):
        (bench / "families" / f"{name}.py").write_text(
            TOY_FAMILY.replace("SCALE = 1.0", f"SCALE = {scale}"))
        (bench / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "family": name, "width": 64}))
        (bench / "limits" / f"{name}.map.json").write_text(json.dumps(
            {"limits": {"wave_gap": 1e-4}}))
        spec["configs"].append({"name": name, "source": "toy",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "toy"})
        spec["workloads"].append({"name": f"{name}.map", "config": name,
                                  "traffic": "toy", "chips": 1,
                                  "why": "toy"})
        p50["workloads"].append(f"{name}.map")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("cell,correct", [("toy.map", True),
                                          ("toy_wrong.map", False)])
def test_a_family_made_of_new_files_runs_on_cpu(toy_root, cell, correct):
    out = harness.run_cell(cell, SEED + 5, 0.2, False, "cpu", toy_root)
    assert out["correct"] is correct, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"clip_latency_p50_s", "setup_s"}
    gap = out["checks"]["wave_gap"]["value"]
    assert gap < 1e-5 if correct else gap == pytest.approx(0.05)
    run = harness.Run(harness.cell(cell, toy_root))
    assert run.flops() == {"map": 2.0 * 32 * 64 ** 2}


def test_the_control_runs_through_a_new_family(toy_root):
    """``control.py``'s sound and control modes build, feed and judge a
    cell of a family that exists only as a file: the toy's control
    computes in bf16 and fails the limit that its sound run passes."""
    limits = harness.cell("toy.map", toy_root).limits
    (_, sound), = control.readings("toy.map", [SEED + 6], int8=False,
                                   device="cpu", root=toy_root)
    (_, low), = control.readings("toy.map", [SEED + 6], int8=True,
                                 device="cpu", root=toy_root)
    assert sound["wave_gap"] <= limits["wave_gap"] < low["wave_gap"]


def _imported(source: str) -> set:
    """The modules an ``import`` or ``from ... import`` of ``source``
    names, a ``from`` import's names each as a module of its own."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("code", [harness, control.readings],
                         ids=["harness", "control.readings"])
def test_the_family_seam_is_the_only_route(code):
    assert not _imported(inspect.getsource(code)) & {
        "benchmark.system", "benchmark.weights", "benchmark.traffic",
        "benchmark.reference.pipeline"}


def test_no_card_means_no_result(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "crossatt3.v2a-single", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
