"""Pre-registered quality gate for the int8-tower serving default.

Counterpart of ``v2ap_tpu/evaluation/int8_gate.py``:

  * A/B: ``run_gate`` generates the same clips with bf16 towers and with int8
    towers (same seed, steps and prompt; the towers flipped in place,
    ``V2APipeline.set_int8_towers``, the feature cache off so both pay the
    towers);
  * score: FAD of the int8 set against the bf16 set on Cnn14 embeddings
    and, when prompts are given, the mean CLAP-similarity delta (the int8
    clip's score minus the bf16 one's, on 48 kHz audio);
  * verdict: int8 stays the default only if the FAD is within the bound
    (default 1.0). It is written to ``gate_file_path()``, which
    ``V2APipeline`` consults through ``read_gate_default`` when
    ``quantize_towers`` is None and ``V2AP_INT8_TOWERS`` is unset.

Run it: ``python -m v2ap_torch.int8_tower_gate --ckpt <converted> --videos
<dir>``. With the evaluators' seeded weights (no published Cnn14 or CLAP
file) the verdict checks the plumbing, not the audio.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

DEFAULT_BOUND_FAD = 1.0


def gate_file_path() -> str:
    """Where the verdict is kept: ``V2AP_INT8_GATE_FILE``, else
    ``int8_gate.json`` in the package directory."""
    return os.environ.get(
        "V2AP_INT8_GATE_FILE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "int8_gate.json"))


def read_gate_default() -> Optional[bool]:
    """The persisted verdict, or None when the gate has never run or its
    file cannot be read."""
    path = gate_file_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return bool(json.load(f)["int8_default"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _generate_set(pipe, videos: Sequence[str], prompts: Sequence[str], *,
                  steps: int, seed: int, int8: bool):
    """One serving variant's wavs, the towers flipped to ``int8`` in place
    (weights untouched)."""
    pipe.set_int8_towers(int8)
    wavs, sr = [], None
    for video, prompt in zip(videos, prompts):
        wav, sr = pipe.generate(video, prompt, steps=steps, seed=seed)
        wavs.append(np.asarray(wav))
    return wavs, sr


def run_gate(pipe, videos: Sequence[str],
             prompts: Optional[Sequence[str]] = None, *,
             steps: int = 25, seed: int = 0,
             bound_fad: float = DEFAULT_BOUND_FAD,
             embedder=None, clap=None, write: bool = True) -> dict:
    """A/B int8 against bf16 towers end to end and persist the verdict.
    ``embedder`` / ``clap`` default to the port's Cnn14 and CLAP scorer
    (tests inject small ones). The towers are left in int8, as JAX's gate
    leaves them."""
    prompts = list(prompts or [""] * len(videos))
    assert len(prompts) == len(videos) and videos, "need >=1 clip"
    # a warm feature cache would make both variants equal by construction
    old_cfg = pipe.cfg
    pipe.cfg = pipe.cfg.replace(conditioning=dataclasses.replace(
        pipe.cfg.conditioning, feature_cache=False))
    try:
        t0 = time.perf_counter()
        wav_bf16, sr = _generate_set(pipe, videos, prompts, steps=steps,
                                     seed=seed, int8=False)
        wav_int8, _ = _generate_set(pipe, videos, prompts, steps=steps,
                                    seed=seed, int8=True)
    finally:
        pipe.cfg = old_cfg

    from v2ap_torch.evaluation import metrics
    if embedder is None:
        embedder = metrics.default_embedder()
    emb_ref = np.concatenate([embedder(w, sr) for w in wav_bf16])
    emb_gen = np.concatenate([embedder(w, sr) for w in wav_int8])
    fad = metrics.fad_from_embeddings(emb_ref, emb_gen)

    clap_delta = None
    scored = [(w8, wb, p) for w8, wb, p in zip(wav_int8, wav_bf16, prompts)
              if p.strip()]
    if scored:
        if clap is None:
            from v2ap_torch.evaluation.clap_scorer import make_clap_scorer
            clap = make_clap_scorer(device=pipe.device)
        deltas = [clap(_to_48k(w8, sr), p) - clap(_to_48k(wb, sr), p)
                  for w8, wb, p in scored]
        clap_delta = float(np.mean(deltas))

    verdict = {
        "int8_default": bool(fad <= bound_fad),
        "fad_int8_vs_bf16": round(float(fad), 4),
        "bound_fad": bound_fad,
        "clap_delta": None if clap_delta is None else round(clap_delta, 4),
        "clips": len(videos), "steps": steps, "seed": seed,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    if write:
        with open(gate_file_path(), "w") as f:
            json.dump(verdict, f, indent=1)
    return verdict


def _to_48k(wav: np.ndarray, sr: int) -> np.ndarray:
    """Linear resampling to 48 kHz (CLAP's rate), as the JAX gate does."""
    if sr == 48_000:
        return wav
    n48 = int(round(len(wav) * 48_000 / sr))
    x = np.arange(n48) * (len(wav) - 1) / max(n48 - 1, 1)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, len(wav) - 1)
    w = (x - i0).astype(np.float32)
    return wav[i0] * (1 - w) + wav[i1] * w
