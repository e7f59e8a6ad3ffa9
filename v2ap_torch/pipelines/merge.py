"""Long-video chunked generation and crossfade merging.

Counterpart of ``v2ap_tpu/pipelines/merge.py``:

  * one video -> a plan of fixed-length chunks that overlap;
  * every chunk through ONE batched sampler call (the chunks ride the batch
    axis: one captured program on CUDA);
  * the chunks' audio joined with equal-power crossfades where they
    overlap;
  * ``merge_wav_files``, the offline concat tool, with an optional
    crossfade.

With ``mesh`` (``parallel.make_mesh``; the pipeline sharded first, by
``V2APipeline.shard_serving``) the chunk batch pads to a multiple of the
data axis's size, each data rank samples its block of chunks, and an
all-gather rebuilds the batch before the decode and the crossfade.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from v2ap_torch.config import SamplerConfig
from v2ap_torch.data.audio_io import read_wav, write_wav
from v2ap_torch.parallel.mesh import batch_sharding
from v2ap_torch.pipelines.generate import bucket_length
from v2ap_torch.utils.jitting import pad_batch


def chunk_plan(duration_s: float, chunk_s: float = 10.0,
               overlap_s: float = 1.0) -> List[Tuple[float, float]]:
    """Cover [0, duration] with chunks of ``chunk_s`` overlapping by
    ``overlap_s``; all chunks have the same length and the last one is
    right-aligned."""
    if duration_s <= chunk_s:
        return [(0.0, duration_s)]
    step = chunk_s - overlap_s
    starts = list(np.arange(0.0, duration_s - chunk_s, step))
    starts.append(duration_s - chunk_s)
    return [(float(s), float(s + chunk_s)) for s in starts]


def crossfade_concat(chunks: np.ndarray, overlap_samples: int) -> np.ndarray:
    """(num_chunks, n) waveforms -> one waveform, with equal-power (cos /
    sin) crossfades over each overlap."""
    num, n = chunks.shape
    if num == 1:
        return chunks[0]
    if not 0 < overlap_samples < n:
        raise ValueError(f"overlap {overlap_samples} not in (0, {n})")
    t = np.linspace(0.0, np.pi / 2.0, overlap_samples, dtype=np.float32)
    fade_out, fade_in = np.cos(t), np.sin(t)
    step = n - overlap_samples
    out = np.zeros(step * (num - 1) + n, np.float32)
    out[:n] = chunks[0]
    for i in range(1, num):
        s = i * step
        out[s: s + overlap_samples] = (
            out[s: s + overlap_samples] * fade_out
            + chunks[i][:overlap_samples] * fade_in)
        out[s + overlap_samples: s + n] = chunks[i][overlap_samples:]
    return out


@torch.inference_mode()
def generate_long(pipeline, video_path: Optional[str], prompt: str = "", *,
                  chunk_s: float = 10.0, overlap_s: float = 1.0,
                  steps: int = 25, cfg_strength: float = 2.0,
                  piano: bool = False, seed: int = 0,
                  max_duration_s: float = 600.0,
                  frames_cache: Optional[list] = None,
                  strips_cache: Optional[list] = None,
                  mesh=None) -> Tuple[np.ndarray, int]:
    """Audio for a video of any length: one frame-feature pass over the
    whole video, the chunks of ``chunk_plan`` as one batch through the
    pipeline's sampler (x0 from ``pipeline._normal(seed, ...)``), then
    ``crossfade_concat``. The video comes as a path or decoded, through
    ``frames_cache`` / ``strips_cache`` as ``V2APipeline.generate`` takes
    them. An empty prompt is a zero context (T5 does not run); a prompt
    goes through T5 once per chunk. ``mesh`` spreads the chunks over the
    data axis (module docstring). Returns (float32 waveform, 24000)."""
    cfg = pipeline.cfg
    cond = cfg.conditioning
    sr = cond.sampling_rate
    dev = pipeline.device

    probe_len = int(max_duration_s * sr / cond.frame_size)
    frames_cache = [] if frames_cache is None else frames_cache
    feats, duration = pipeline.encode_video_frames_clip(
        video_path, probe_len, frames_cache=frames_cache)
    if duration is None:
        raise ValueError(f"cannot decode {video_path}")
    duration = min(duration, max_duration_s)

    plan = chunk_plan(duration, chunk_s, overlap_s)
    n_chunk = int(round(chunk_s * sr / cond.frame_size))
    n = bucket_length(n_chunk)
    b = len(plan)
    tdim = cfg.model.dim_text_raw or cfg.model.dim_text
    text = torch.zeros(b, n, tdim, device=dev)
    frames_roll = torch.zeros(b, n, cfg.model.notes, device=dev)
    strips = None
    if piano:
        strips = pipeline.encode_piano_frames(video_path, probe_len,
                                              frames_cache=frames_cache,
                                              strips_cache=strips_cache)
    for i, (s, _) in enumerate(plan):
        off = int(round(s * sr / cond.frame_size))
        sl = feats[off: off + n_chunk]
        text[i, : len(sl)] = sl
        if strips is not None:
            # roll rows advance at video_multi x frame_size
            vm = cfg.model.video_multi
            r0 = int(round(off / vm))
            rows = int(np.floor(n_chunk / vm)) + 1
            roll = pipeline._roll_from_strips(
                pipeline._ship_strips(strips[r0: r0 + rows]), n_chunk)
            frames_roll[i, :n_chunk] = roll[0]

    if prompt.strip():
        ctx, ctx_mask = pipeline.encode_text([prompt] * b)
    else:
        # a zero context of any length equals the zeroed T5 output
        ctx = torch.zeros(b, 1, cfg.model.dim_context, device=dev)
        ctx_mask = torch.ones(b, 1, dtype=torch.bool, device=dev)
    mask = (torch.arange(n, device=dev)[None, :] < n_chunk).repeat(b, 1)
    x0 = pipeline._normal(seed, (b, n, cfg.model.num_channels))
    sampler = SamplerConfig(steps=steps, cfg_strength=cfg_strength)
    inputs = (x0, text, frames_roll, ctx, ctx_mask, mask)
    if mesh is not None:
        # the chunks pad to a multiple of the data axis (the last one
        # repeated) and each data rank samples its block
        rows = batch_sharding(mesh)
        size = -(-b // rows.size) * rows.size
        inputs = tuple(rows.shard(pad_batch(t, size)) for t in inputs)
    latents = pipeline._sample(*inputs, sampler)
    if mesh is not None:
        latents = rows.gather(latents)[:b]
    wavs = pipeline.codec.decode(latents[:, :n_chunk]).cpu().numpy()
    wavs = wavs[:, : n_chunk * cond.frame_size]
    merged = crossfade_concat(wavs, int(overlap_s * sr)) if b > 1 else wavs[0]
    return merged[: int(duration * sr)], sr


def merge_wav_files(paths: Sequence[str], out_path: str,
                    crossfade_s: float = 0.0) -> str:
    """Join WAV files end to end into ``out_path``: plain concatenation, or
    ``crossfade_concat`` over ``crossfade_s`` (the files zero-padded to
    the longest). Every file must have the first one's sample rate."""
    parts = []
    sr = None
    for p in paths:
        audio, this_sr = read_wav(p)
        sr = sr or this_sr
        if this_sr != sr:
            raise ValueError(f"{p}: sample rate {this_sr} != {sr}")
        parts.append(audio[0])
    if crossfade_s <= 0:
        merged = np.concatenate(parts)
    else:
        n = max(len(p) for p in parts)
        padded = np.stack([np.pad(p, (0, n - len(p))) for p in parts])
        merged = crossfade_concat(padded, int(crossfade_s * sr))
    write_wav(out_path, merged, sr)
    return out_path
