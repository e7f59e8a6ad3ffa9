"""Batch evaluation over scp manifests, the engine of the batch CLIs
(``v2ap_torch.inference_v2a``, ``inference_v2p``, ``evaluate``).

Counterpart of ``v2ap_tpu/pipelines/batch_eval.py``: manifest rows
``[start:end:step]``, one ``pipeline.generate`` per clip (seed + i, the
caption behind ``caption_prefix`` unless ``drop_prompt``), a wav per clip
(and the clip muxed onto its video where ffmpeg exists), optional CLAP
caption-audio scores, and ``summary.json``. A clip that fails is recorded
and skipped; the CLIs exit 1 when any did.

The pipeline reads a video path as ``V2APipeline.generate`` does: from the
feature (and strip / roll) caches beside the video when they exist, else
by decoding it with cv2. A machine without cv2 evaluates from primed caches.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from v2ap_torch.data.manifests import CorpusSpec, load_corpus


def run_batch_eval(
    pipeline,
    scp_path: str,
    out_dir: str,
    *,
    start: int = 0,
    end: Optional[int] = None,
    step: int = 1,
    caption_prefix: str = "",
    steps: int = 64,
    cfg_strength: float = 2.0,
    drop_prompt: bool = False,
    piano: bool = False,
    seed: int = 0,
    mux: bool = True,
    passes: int = 1,
    clap_scores: bool = False,
) -> dict:
    """Returns the summary: clips attempted / succeeded / failed, audio and
    wall seconds, the realtime factor, and per-clip CLAP scores when
    ``clap_scores`` and a scorer is registered (``data.clap_filter``)."""
    from v2ap_torch.data import clap_filter
    from v2ap_torch.data.audio_io import write_wav
    from v2ap_torch.data.video_io import mux_audio_onto_video

    # the slicing and the "the sound of " prefix follow the reference's
    # vgg_test eval path
    samples = load_corpus(CorpusSpec("eval", scp_path, is_video=True,
                                     is_piano=piano))
    samples = samples[start:end:max(1, step)]
    os.makedirs(out_dir, exist_ok=True)

    done, failed = 0, 0
    audio_s, wall_s = 0.0, 0.0
    clap_rows: list = []
    for i, sample in enumerate(samples):
        prompt = "" if drop_prompt else (
            caption_prefix + (sample.caption or ""))
        t0 = time.perf_counter()
        try:
            wav, sr = pipeline.generate(
                sample.path, prompt, steps=steps, cfg_strength=cfg_strength,
                piano=piano, seed=seed + i, passes=passes)
        except Exception as exc:  # a bad clip: record it and go on
            failed += 1
            print(f"[batch_eval] FAILED {sample.path}: {exc}")
            continue
        wall_s += time.perf_counter() - t0
        audio_s += len(wav) / sr
        stem = os.path.splitext(os.path.basename(sample.path))[0]
        write_wav(os.path.join(out_dir, f"{stem}.wav"), wav, sr)
        if mux:
            mux_audio_onto_video(sample.path, wav, sr,
                                 os.path.join(out_dir, f"{stem}.mp4"))
        if clap_scores:
            s = clap_filter.score(wav[None], sr, sample.caption or "")
            if s is not None:
                clap_rows.append({"clip": stem, "clap": round(s, 4)})
        done += 1

    summary = {
        "clips": len(samples), "succeeded": done, "failed": failed,
        "audio_seconds": round(audio_s, 2), "wall_seconds": round(wall_s, 2),
        "realtime_factor": round(audio_s / wall_s, 3) if wall_s else None,
    }
    if clap_scores and clap_rows:
        summary["clap_mean"] = round(
            sum(r["clap"] for r in clap_rows) / len(clap_rows), 4)
        summary["clap_scores"] = clap_rows
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
