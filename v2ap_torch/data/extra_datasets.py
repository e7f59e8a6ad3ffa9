"""More corpus adapters: Hugging Face audio datasets and TTS manifests.

Counterpart of ``v2ap_tpu/data/extra_datasets.py``. Both are host-side
numpy batchers drawing from ``np.random.default_rng(seed)`` in the JAX
package's order, so that a seed gives the same batches in both packages:

  * ``HFAudioDataset``: rows of a ``datasets.Dataset`` (``audio`` with
    ``array`` and ``sampling_rate``, a caption under ``text``); clips
    outside [min_seconds, max_seconds] are skipped and redrawn, the rest
    resampled to 24 kHz, normalised and padded or repeated to the target
    length. ``from_hub`` needs the ``datasets`` package and the network.
  * ``TextToSpeechDataset``: a manifest of ``wav_path|transcript`` (or
    tab-separated) rows, oversampled ``multi`` times, clips through
    ``audio_io.load_training_clip``, transcripts through
    ``data.tokenizers``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from v2ap_torch.data.audio_io import (
    HOP_SIZE, load_training_clip, normalize_wav, pad_or_repeat, resample,
)
from v2ap_torch.data.tokenizers import get_tokenizer


class HFAudioDataset:
    def __init__(self, dataset, *, sample_rate: int = 24_000,
                 min_seconds: float = 0.3, max_seconds: float = 20.0,
                 audio_key: str = "audio", text_key: str = "text"):
        self.ds = dataset
        self.sample_rate = sample_rate
        self.min_s = min_seconds
        self.max_s = max_seconds
        self.audio_key = audio_key
        self.text_key = text_key

    @classmethod
    def from_hub(cls, name: str, split: str = "train", **kw):
        try:
            import datasets
        except ImportError as exc:
            raise ImportError("HFAudioDataset requires the 'datasets' "
                              "package") from exc
        return cls(datasets.load_dataset(name, split=split), **kw)

    def __len__(self) -> int:
        return len(self.ds)

    def get(self, index: int) -> Optional[Tuple[np.ndarray, str]]:
        """(waveform (1, n) at ``sample_rate``, caption), or None when the
        clip's duration is out of bounds."""
        row = self.ds[int(index)]
        audio = row[self.audio_key]
        arr = np.asarray(audio["array"], np.float32)[None]
        sr = int(audio["sampling_rate"])
        if not self.min_s <= arr.shape[-1] / sr <= self.max_s:
            return None
        arr = resample(arr, sr, self.sample_rate)
        return normalize_wav(arr), str(row.get(self.text_key, ""))

    def batches(self, batch_size: int, target_frames: int = 750,
                seed: int = 0) -> Iterator[dict]:
        """Endless batches: ``waveforms`` (b, target_frames * 320),
        ``lens`` (b,) and ``captions``."""
        rng = np.random.default_rng(seed)
        n_samples = target_frames * HOP_SIZE
        while True:
            wavs, caps = [], []
            while len(wavs) < batch_size:
                item = self.get(int(rng.integers(len(self.ds))))
                if item is None:
                    continue
                wavs.append(pad_or_repeat(item[0], n_samples)[0])
                caps.append(item[1])
            yield {"waveforms": np.stack(wavs),
                   "lens": np.full((batch_size,), target_frames, np.int32),
                   "captions": caps}


class TextToSpeechDataset:
    """Rows ``wav_path|transcript`` (or tab-separated), each ``multi``
    times in ``len``."""

    def __init__(self, scp_path: str, *, multi: int = 8,
                 tokenizer: str = "char_utf8"):
        self.rows: List[Tuple[str, str]] = []
        with open(scp_path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("|" if "|" in line else "\t", 1)
                self.rows.append((parts[0], parts[1] if len(parts) > 1
                                  else ""))
        self.multi = multi
        self.encode, self.vocab_size = get_tokenizer(tokenizer)

    def __len__(self) -> int:
        return len(self.rows) * self.multi

    def batches(self, batch_size: int, target_frames: int = 750,
                seed: int = 0) -> Iterator[dict]:
        """Batches of ``waveforms``, ``lens``, ``tokens`` (-1 padded) and
        ``texts``; rows whose clip does not load are redrawn, up to 16 draws
        a row, and the iterator ends when a batch gets none."""
        rng = np.random.default_rng(seed)
        while True:
            wavs, texts = [], []
            attempts = 0
            while len(wavs) < batch_size and attempts < 16 * batch_size:
                attempts += 1
                path, text = self.rows[int(rng.integers(len(self.rows)))]
                clip = load_training_clip(path, target_frames)
                if clip is None:
                    continue
                wavs.append(clip[0])
                texts.append(text)
            if not wavs:
                return
            yield {"waveforms": np.stack(wavs),
                   "lens": np.full((len(wavs),), target_frames, np.int32),
                   "tokens": self.encode(texts), "texts": texts}
