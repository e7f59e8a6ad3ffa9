"""The v2ap family: ``v2ap_torch``'s ``V2APipeline`` (V2A, V2P, batched
V2A), the family of every configuration without a ``"family"`` key.

It gives the harness the names that ``benchmark/harness.py``'s docstring
lists, from where the parts live: the system ``benchmark/system.py``,
the seeded weights ``benchmark/weights.py``, the traffic
``benchmark/traffic.py``, the operation count ``benchmark/counts.py``,
and below the readings that ``benchmark/check.py`` judges, held against
the plain reference ``benchmark/reference/pipeline.py``. Its faults are
``benchmark/faults.py``'s, planted in ``benchmark.system.System`` and the
port.
"""

from __future__ import annotations

import torch

from benchmark import check, counts, harness
from benchmark.reference import pipeline as reference
from benchmark.reference.nn import int8_linear
from benchmark.system import System
from benchmark.traffic import Traffic
from benchmark.weights import make


def build(config: dict, device, control: bool = False) -> System:
    """The pipeline of ``config``; ``control`` runs the port's own int8
    product in every ``Linear`` instead of the configuration's precision
    (``System(int8=True)``)."""
    return System(config, device, int8=control)


def weights(config: dict, traffic: dict, seed: int, device) -> dict:
    """The configuration's weights drawn from ``seed``, T5's only where
    the traffic sends prompts."""
    return make(config, seed, device,
                with_t5=traffic["prompt_words"][1] > 0)


def prepare(system: System, request: dict, kind: str):
    """A batch call's x0, drawn before the clock starts; None otherwise."""
    return system.x0(request) if kind == "batch" else None


def serve(system: System, request: dict, kind: str, prepared):
    return system.serve(request, kind, prepared)


request_flops = counts.request_flops


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


def reference_readings(c, run, seed: int, device) -> dict:
    """The program's answers held against the reference: the checked
    requests (drawn from the seed) of the completed ones. Under int8
    towers the check goes in stages: ``layer_gap`` holds a few of the
    towers' int8 layers on their own inputs, ``feature_gap`` the towers'
    features against the reference towers', and the waveform is held
    against the reference's sampler and decoder run from the program's own
    features."""
    traffic = Traffic(c.traffic, seed)
    done = [r for r in run.records if r.waves is not None]
    w = weights(c.config, c.traffic, harness.weights_seed(seed), device)
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
