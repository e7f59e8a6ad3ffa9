"""A benchmark root at miniature sizes, for the CPU tests: the port's
``tiny_tower_test`` model with its tiny towers, T5 and codec, written as a
configuration file beside tiny traffic, limits and a BENCHMARK.json, with
the committed metric readers and families copied in."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from v2ap_torch.config import tiny_tower_test
from v2ap_torch.models.clip_vit import clip_tiny_test
from v2ap_torch.models.convnext import convnext_tiny_test
from v2ap_torch.models.dinov2 import dinov2_tiny_test
from v2ap_torch.models.encodec import EncodecConfig
from v2ap_torch.models.t5 import t5_tiny_test

REPO = Path(__file__).resolve().parents[2]


def _d(x) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(x).items()}


def tiny_config(mode: str = "clip_vit", frame_stride: int = 3,
                strip_stride: int = 2, quantize_towers: bool = False) -> dict:
    cfg = tiny_tower_test()
    towers = {"clip_vit": _d(clip_tiny_test()),
              "clip_vit2": _d(dataclasses.replace(
                  clip_tiny_test(), hidden_act="quick_gelu", image_size=42)),
              "clip_convnext": _d(convnext_tiny_test()),
              "dinov2": _d(dinov2_tiny_test())}
    if mode != "mixed":
        towers = {mode: towers[mode]}
    widths = {"clip_vit": 16, "clip_vit2": 16, "clip_convnext": 24,
              "dinov2": 32}
    model = _d(cfg.model)
    if mode == "mixed":
        model["dim_text_raw"] = sum(widths.values())
    cond = _d(cfg.conditioning)
    cond.update(video_encoder=mode, frame_stride=frame_stride,
                strip_stride=strip_stride)
    return {"name": "tiny", "source": "tiny_tower_test", "model": model,
            "sampler": _d(cfg.sampler), "conditioning": cond,
            "towers": towers, "t5": _d(t5_tiny_test()),
            "encodec": _d(EncodecConfig(hidden_size=8, num_filters=4,
                                        num_lstm_layers=1)),
            "quantize_towers": quantize_towers, "quantize_cfm": False}


def tiny_traffic(kind: str = "single", piano: bool = False) -> dict:
    return {"kind": kind, "clip_s": 1.6, "fps": 5, "width": 48,
            "height": 36, "piano": piano, "strip_h": 100, "strip_w": 900,
            "prompt_words": [3, 6] if piano else [0, 0],
            "batch": 2 if kind == "batch" else 1, "pool": 2, "checked": 2,
            "trace_requests": 1, "warmup": 1}


CELLS = {"tiny.v2a": ("tiny", "v2a", tiny_traffic()),
         "tiny.v2p": ("tiny", "v2p", tiny_traffic(piano=True)),
         "tiny.batch": ("tiny", "batch", tiny_traffic("batch")),
         "tiny-mixed.v2a": ("tiny-mixed", "v2a", tiny_traffic()),
         "tiny-int8.v2a": ("tiny-int8", "v2a", tiny_traffic()),
         "tiny-int8.batch": ("tiny-int8", "batch", tiny_traffic("batch"))}


def make_root(tmp: Path, limit: float = 1e-3) -> Path:
    """A benchmark root under ``tmp`` with the tiny cells of ``CELLS``."""
    root = Path(tmp)
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "families"):
        shutil.copytree(REPO / "benchmark" / sub, bench / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {"tiny": tiny_config(), "tiny-mixed": tiny_config("mixed"),
               "tiny-int8": tiny_config(quantize_towers=True)}
    spec["configs"] = []
    for name, c in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(c))
        spec["configs"].append({"name": name, "source": "tiny",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "tiny"})
    spec["workloads"] = []
    for cell, (config, traffic, params) in CELLS.items():
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(params))
        limits = {"wave_gap": limit}
        if params["piano"]:
            limits["roll_gap"] = limit
        if configs[config]["quantize_towers"]:
            limits["feature_gap"] = limits["layer_gap"] = limit
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tiny"})
    kinds = {k: [c for c, v in CELLS.items() if v[2]["kind"] == k]
             for k in ("single", "batch")}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            part = "batch" if m["name"] in ("audio_s_per_s",) or \
                m["name"].endswith(".batch") else "single"
            m["workloads"] = kinds[part]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
