"""CLAP-score audio / caption filtering interface.

Counterpart of ``v2ap_tpu/data/clap_filter.py``: a pluggable scorer

    set_scorer(fn)           # fn(waveform_48k: np.ndarray, caption: str) -> float
    passes(waveform, sr, caption, threshold)  -> (score, keep)

(``evaluation.clap_scorer.make_clap_scorer`` builds one). Corpus thresholds
come from ``CorpusSpec.score_threshold`` (``data/manifests.py``). Without a
scorer every clip passes with score None.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

_SCORER: Optional[Callable[[np.ndarray, str], float]] = None

CLAP_SAMPLE_RATE = 48_000


def set_scorer(fn: Optional[Callable[[np.ndarray, str], float]]) -> None:
    global _SCORER
    _SCORER = fn


def has_scorer() -> bool:
    return _SCORER is not None


def score(waveform: np.ndarray, sr: int, caption: str) -> Optional[float]:
    """waveform (1, n) at ``sr`` -> CLAP similarity, or None without a
    scorer. Resampled to 48 kHz on the host."""
    if _SCORER is None:
        return None
    from v2ap_torch.data.audio_io import resample
    wav = resample(waveform, sr, CLAP_SAMPLE_RATE)[0]
    return float(_SCORER(wav, caption))


def passes(waveform: np.ndarray, sr: int, caption: str,
           threshold: Optional[float]) -> Tuple[Optional[float], bool]:
    """-> (score, keep). Threshold None disables filtering."""
    if threshold is None or _SCORER is None:
        return None, True
    s = score(waveform, sr, caption)
    return s, s is None or s >= threshold
