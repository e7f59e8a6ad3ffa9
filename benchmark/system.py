"""The system under test: ``v2ap_torch``'s serving pipeline, built from a
configuration file and driven through its two serving entries,
``V2APipeline.generate`` (one clip) and ``generate_batch`` (one call of
several clips). This is the only module of the benchmark that imports the
port, and it imports it only when a pipeline is built.
"""

from __future__ import annotations

import os

import torch

# the port's environment switches that change what it computes; the
# configuration file states each of them instead
PORT_SWITCHES = ("V2AP_INT8_TOWERS", "V2AP_INT8_CFM", "V2AP_SHIP_YUV420",
                 "V2AP_SHIP_STRIP_HALF", "V2AP_FRAME_STRIDE",
                 "V2AP_STRIP_STRIDE", "V2AP_STREAM_DECODE",
                 "V2AP_T5_TOKENIZER", "V2AP_INT8_GATE_FILE")


def clear_switches() -> None:
    for name in PORT_SWITCHES:
        os.environ.pop(name, None)


class System:
    """A ``V2APipeline`` of configuration ``cfg`` (a configuration file's
    dict) on ``device``; ``int8`` runs the port's own int8 product
    (``utils.quantize``) in every ``Linear`` of the towers, T5 and the flow
    model instead of the file's precision: the correctness control.

    Under int8 towers (``quantize_towers``) hooks on each tower keep what
    the check compares of a call (``kept``: ``benchmark/kept.py``'s
    features and layers, on the device; no copy, no sync)."""

    def __init__(self, cfg: dict, device, *, int8: bool = False):
        from v2ap_torch.config import V2APConfig
        from v2ap_torch.models.clip_vit import CLIPVisionConfig
        from v2ap_torch.models.convnext import ConvNextConfig
        from v2ap_torch.models.dinov2 import Dinov2Config
        from v2ap_torch.models.encodec import EncodecConfig
        from v2ap_torch.models.t5 import T5Config
        from v2ap_torch.pipelines.generate import V2APipeline

        classes = {"clip_vit": CLIPVisionConfig,
                   "clip_vit2": CLIPVisionConfig,
                   "clip_convnext": ConvNextConfig, "dinov2": Dinov2Config}

        def make(cls, d):
            return cls(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})

        clear_switches()
        self.cfg, self.device = cfg, device
        v2ap = V2APConfig.from_dict({k: cfg[k] for k in
                                     ("model", "sampler", "conditioning")})
        self.pipe = V2APipeline(
            v2ap, seed=0, device=device,
            t5_config=make(T5Config, cfg["t5"]),
            encodec_config=make(EncodecConfig, cfg["encodec"]),
            tower_configs={name: make(classes[name], c)
                           for name, c in cfg["towers"].items()},
            quantize_towers=int8 or cfg["quantize_towers"],
            quantize_cfm=int8 or cfg["quantize_cfm"])
        if int8:
            # the same int8 product on T5's Linears, so that no bf16 part
            # of the request stays outside the control
            from v2ap_torch.utils.quantize import quantize_linears_int8

            quantize_linears_int8(self.pipe.t5, True)
        self.kept = None                # inside ``serve``: kept.empty()
        if cfg["quantize_towers"]:
            from benchmark import kept

            for tower in self.pipe.towers:
                kept.keep(tower.model, tower.name, lambda: self.kept)

    def load(self, weights: dict) -> None:
        """Copy the benchmark's weights into the pipeline's modules,
        strictly by name and in place (captured programs keep their
        addresses)."""
        pipe = self.pipe
        pipe.cfm.load_state_dict(weights["cfm"], strict=True)
        pipe.codec.decoder.load_state_dict(weights["decoder"], strict=True)
        if "t5" in weights:
            pipe.t5.load_state_dict(weights["t5"], strict=True)
        for tower in pipe.towers:
            tower.model.load_state_dict(weights["towers"][tower.name],
                                        strict=True)

    def x0(self, call: dict) -> torch.Tensor:
        """A batch call's x0 (b, n, C) float32, drawn on the device from the
        call's seed by the benchmark and handed to the pipeline."""
        from benchmark.reference.pipeline import normal, plan_length

        _, _, n = plan_length(self.cfg, call["duration"])
        return normal(call["x0_seed"], (len(call["frames"]), n,
                                        self.cfg["model"]["num_channels"]),
                      self.device)

    def serve(self, request: dict, kind: str, x0=None):
        """One timed call. Returns the waveforms as float32 numpy (1 or b
        rows), the roll the call produced (V2P, on the device) and the
        pipeline's timings of the call."""
        pipe, s = self.pipe, self.cfg["sampler"]
        if self.cfg["quantize_towers"]:
            from benchmark import kept

            self.kept = kept.empty()
        if kind == "batch":
            wavs, _ = pipe.generate_batch(
                [None] * len(request["frames"]), request["prompts"],
                duration_s=request["duration"], steps=s["steps"],
                cfg_strength=s["cfg_strength"],
                frames_caches=[[(f, request["duration"], 1)]
                               for f in request["frames"]], x0=x0)
            return wavs, None, dict(pipe.last_timings)
        piano = request["strips"] is not None
        wav, _ = pipe.generate(
            None, request["prompt"], steps=s["steps"],
            cfg_strength=s["cfg_strength"], piano=piano,
            seed=request["seed"],
            frames_cache=[(request["frames"], request["duration"], 1)],
            strips_cache=([(request["strips"], request["duration"])]
                          if piano else None))
        return (wav[None], pipe.last_roll if piano else None,
                dict(pipe.last_timings))
