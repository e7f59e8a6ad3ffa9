"""The general traffic generator: a traffic file's parameters and a seed ->
a pool of clips made at set-up and the stream of requests that cycles
through it.

A traffic file (``benchmark/traffic/<name>.json``) holds:

  kind            "single" (``generate``, one clip a request) or "batch"
                  (``generate_batch``, ``batch`` clips a call, x0 given)
  clip_s, fps     clip length in seconds and its frame rate
  width, height   uploaded frame size (uint8 RGB, resized on the device)
  piano           keyboard strips too (V2P)
  strip_h/strip_w strip size (uint8 grayscale, one a frame)
  prompt_words    [lo, hi]: words a prompt has, drawn uniformly ([0, 0]:
                  the empty prompt)
  batch           clips a call
  pool            distinct clips made at set-up
  checked         requests (single) or calls (batch) held against the
                  reference after the window, drawn from the seed
  trace_requests  requests (or calls) the ``--trace 1`` run profiles
  warmup          calls made in set-up

Every seed gives the same sizes; the seed draws the pixels, strips,
prompts, sampler seeds and x0.
"""

from __future__ import annotations

import numpy as np
import torch

# prompts are drawn from these words (a hash tokenizer pads every prompt to
# 64 tokens, so their choice changes no shape)
WORDS = ("a grand piano plays a slow gentle melody in a quiet room with "
         "soft reverb while rain falls on the window and a dog barks far "
         "away then footsteps cross a wooden floor birds sing wind blows "
         "through trees water splashes an engine hums children laugh a "
         "door closes bright staccato chords low bass notes fast arpeggios "
         "classical jazz ballad waltz lively sad calm").split()


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = int(seed)
        self.rng = np.random.default_rng([self.seed, 1])
        self.frames_n = int(round(params["clip_s"] * params["fps"]))

    @property
    def kind(self) -> str:
        return self.p["kind"]

    @property
    def clips_per_call(self) -> int:
        return self.p["batch"] if self.kind == "batch" else 1

    def make_pool(self, device) -> list:
        """``pool`` clips: dicts of uint8 frames (t, H, W, 3) and, for
        piano traffic, strips (t, strip_h, strip_w), as host numpy arrays,
        drawn on ``device`` in one call each."""
        p = self.p
        gen = torch.Generator(device=device).manual_seed(
            int(self.rng.integers(2 ** 62)))
        pool = []
        for _ in range(p["pool"]):
            clip = {"frames": torch.randint(
                0, 256, (self.frames_n, p["height"], p["width"], 3),
                generator=gen, dtype=torch.uint8, device=device).cpu().numpy()}
            if p["piano"]:
                clip["strips"] = torch.randint(
                    0, 256, (self.frames_n, p["strip_h"], p["strip_w"]),
                    generator=gen, dtype=torch.uint8,
                    device=device).cpu().numpy()
            pool.append(clip)
        return pool

    def prompt(self) -> str:
        lo, hi = self.p["prompt_words"]
        k = int(self.rng.integers(lo, hi + 1))
        return " ".join(self.rng.choice(WORDS, size=k)) if k else ""

    def request(self, i: int, pool: list) -> dict:
        """Request (or call) ``i``: single -> frames, duration, prompt,
        strips, seed; batch -> frames (a list), duration, prompts,
        x0_seed."""
        dur = float(self.p["clip_s"])
        if self.kind == "batch":
            b = self.p["batch"]
            clips = [pool[(i * b + j) % len(pool)] for j in range(b)]
            return {"frames": [c["frames"] for c in clips], "duration": dur,
                    "prompts": [self.prompt() for _ in range(b)],
                    "x0_seed": int(self.rng.integers(2 ** 62))}
        clip = pool[i % len(pool)]
        return {"frames": clip["frames"], "duration": dur,
                "prompt": self.prompt(), "strips": clip.get("strips"),
                "seed": int(self.rng.integers(2 ** 62))}

    def checked(self, completed: int) -> list:
        """Indices of the completed requests held against the reference:
        ``checked`` of them, drawn from the seed (all, if fewer)."""
        k = min(self.p["checked"], completed)
        pick = np.random.default_rng([self.seed, 2]).choice(
            completed, size=k, replace=False)
        return sorted(int(i) for i in pick)
