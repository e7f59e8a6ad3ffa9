"""Audeo datasets: keyboard-frame windows + multilabel balanced sampling,
and roll-chunk pairs for the Roll2Midi GAN.

Counterpart of ``v2ap_tpu/audeo/datasets.py``: numpy on the host, the same
draws from ``numpy.random.default_rng(seed)``; the two inference helpers
run the networks on their own device and hand numpy back.

Behavioral model (reference: Video2Roll_dataset.py, balance_data.py,
Roll2Midi_dataset*.py): samples are 5-consecutive-frame grayscale 100x900
stacks labelled with the active keys (51-key window 15..65 of the 88-key
roll); minority keys are oversampled by picking a class uniformly, then a
sample containing it ("multilabel balanced random sampling"). Roll2Midi pairs
are 50-frame (2 s) roll-probability chunks vs binarised GT midi chunks,
concatenated two at a time into (keys, 100) windows.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

MIN_KEY = 15
MAX_KEY = 65
FRAMES_PER_CHUNK = 50


@torch.inference_mode()
def _call(net, x: torch.Tensor) -> torch.Tensor:
    return net(x)


def _device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class Video2RollSamples:
    """In-memory (frames, labels) windows with balanced sampling."""

    def __init__(self, frames: np.ndarray, labels: np.ndarray,
                 window: int = 5, seed: int = 0):
        """frames: (t, H, W) grayscale [0,1]; labels: (t, keys) binary."""
        assert len(frames) == len(labels)
        self.frames = frames
        self.labels = labels.astype(np.float32)
        self.window = window
        self.rng = np.random.default_rng(seed)
        # class -> sample indices containing it
        self.class_map: List[np.ndarray] = [
            np.where(self.labels[:, c] > 0)[0]
            for c in range(self.labels.shape[1])]
        self.nonempty = [c for c, lst in enumerate(self.class_map)
                         if len(lst) > 0]

    def window_at(self, i: int) -> np.ndarray:
        half = self.window // 2
        idx = np.clip(np.arange(i - half, i + half + 1), 0, len(self.frames) - 1)
        return self.frames[idx]

    def balanced_batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray,
                                                                  np.ndarray]]:
        """Yield balanced (b, window, H, W) stacks + (b, keys) labels."""
        while True:
            idxs = []
            for _ in range(batch_size):
                if self.nonempty and self.rng.random() < 0.9:
                    c = self.nonempty[int(self.rng.integers(len(self.nonempty)))]
                    pool = self.class_map[c]
                    idxs.append(int(pool[int(self.rng.integers(len(pool)))]))
                else:
                    idxs.append(int(self.rng.integers(len(self.frames))))
            stacks = np.stack([self.window_at(i) for i in idxs])
            yield stacks, self.labels[idxs]


def video2roll_infer_chunks(
    net, frames: np.ndarray, *, chunk: int = FRAMES_PER_CHUNK,
    window: int = 5, threshold: float = 0.4,
    min_key: int = MIN_KEY, max_key: int = MAX_KEY,
    out_dir: Optional[str] = None, batch_fn=None,
) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Chunked offline Video2Roll inference (reference
    Video2Roll_inference.py:57-86): 5-frame sliding windows -> logits ->
    sigmoid>=threshold rolls, emitted per 2-s chunk as 88-wide (logit, roll)
    pairs; optionally saved as ``{start}-{end}.npz``.

    ``batch_fn(net, stacks)->logits`` replaces ``net(stacks)``; the stacks
    arrive as a float32 tensor on the net's device.
    """
    t = len(frames)
    half = window // 2
    results = []
    if batch_fn is None:
        batch_fn = _call
    device = next(net.parameters()).device
    for start in range(0, t, chunk):
        end = min(start + chunk, t)
        idx = (np.arange(start, end)[:, None]
               + np.arange(-half, half + 1)[None, :])
        idx = np.clip(idx, 0, t - 1)
        stacks = frames[idx]                       # (c, window, H, W)
        logits = _numpy(batch_fn(net, _device(stacks, device)))
        probs = 1.0 / (1.0 + np.exp(-logits))
        roll_small = (probs >= threshold).astype(np.int64)
        n_keys = max_key - min_key + 1
        logit88 = np.zeros((end - start, 88), np.float32)
        roll88 = np.zeros((end - start, 88), np.int64)
        logit88[:, min_key: min_key + n_keys] = logits[:, :n_keys]
        roll88[:, min_key: min_key + n_keys] = roll_small[:, :n_keys]
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            np.savez(os.path.join(out_dir, f"{start}-{end}.npz"),
                     logit=logit88, roll=roll88)
        results.append((start, end, logit88, roll88))
    return results


class Roll2MidiPairs:
    """(roll-probability window, binarised GT) pairs for the GAN, built from
    per-chunk arrays; two 50-frame chunks concatenate into 100-frame windows
    (reference Roll2Midi_dataset.py / Roll2Midi_inference.py:12-40)."""

    def __init__(self, logits: Sequence[np.ndarray],
                 gt_rolls: Sequence[np.ndarray],
                 min_key: int = MIN_KEY, max_key: int = MAX_KEY):
        self.windows = []
        n_keys = max_key - min_key + 1
        for i in range(0, len(logits) - 1, 2):
            prob = np.concatenate([logits[i], logits[i + 1]])[:,
                                                              min_key:max_key + 1]
            prob = 1.0 / (1.0 + np.exp(-prob))
            gt = np.concatenate([gt_rolls[i], gt_rolls[i + 1]])[:,
                                                                min_key:max_key + 1]
            gt = (gt > 0).astype(np.float32)
            # (keys, frames, 1) NHWC windows
            self.windows.append((prob.T[..., None].astype(np.float32),
                                 gt.T[..., None]))
        assert self.windows, "need at least two chunks"

    def __len__(self):
        return len(self.windows)

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.integers(len(self.windows), size=batch_size)
            rolls = np.stack([self.windows[i][0] for i in idx])
            gts = np.stack([self.windows[i][1] for i in idx])
            yield rolls, gts


def load_roll_chunk_dir(folder: str) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load sorted {start}-{end}.npz chunks -> (logits, rolls) lists."""
    files = sorted(glob.glob(os.path.join(folder, "*.npz")),
                   key=lambda x: int(os.path.basename(x).split("-")[0]))
    logits, rolls = [], []
    for f in files:
        with np.load(f) as data:
            logits.append(data["logit"])
            rolls.append(data["roll"])
    return logits, rolls


def roll2midi_infer(generator, logits, *, min_key: int = MIN_KEY,
                    max_key: int = MAX_KEY, threshold: float = 0.4,
                    out_dir: Optional[str] = None, batch_fn=None):
    """Clean estimated rolls with the Roll2Midi generator (reference
    Roll2Midi_inference.py:12-40): sigmoid(logits) in 100-frame window pairs
    -> generator -> thresholded 88-wide midi chunks, optionally saved per
    input chunk as {start}-{end}.npz with key 'midi'. Pairs of chunks run
    on the generator's device; an odd last chunk is dropped, as in JAX."""
    if batch_fn is None:
        batch_fn = _call
    device = next(generator.parameters()).device
    n_keys = max_key - min_key + 1
    outs = []
    for i in range(0, len(logits) - 1, 2):
        pair = np.concatenate([logits[i], logits[i + 1]])[:, min_key:max_key + 1]
        prob = 1.0 / (1.0 + np.exp(-pair))
        window = prob.T[None, ..., None].astype(np.float32)  # (1, keys, 100, 1)
        gen = _numpy(batch_fn(generator, _device(window, device)))[0, ..., 0]
        midi_pair = (gen.T >= threshold).astype(np.int64)    # (100, keys)
        for j, start in enumerate((i * FRAMES_PER_CHUNK,
                                   (i + 1) * FRAMES_PER_CHUNK)):
            midi = np.zeros((FRAMES_PER_CHUNK, 88), np.int64)
            midi[:, min_key: min_key + n_keys] = \
                midi_pair[j * FRAMES_PER_CHUNK: (j + 1) * FRAMES_PER_CHUNK]
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                np.savez(os.path.join(
                    out_dir, f"{start}-{start + FRAMES_PER_CHUNK}.npz"),
                    midi=midi)
            outs.append(midi)
    return outs
