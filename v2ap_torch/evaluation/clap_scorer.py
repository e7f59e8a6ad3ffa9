"""CLAP audio-text scorer: ``models.clap.ClapModel`` as the callable that
the filter registry (``data.clap_filter.set_scorer``) and the metrics'
``clap_similarity`` take.

Counterpart of ``v2ap_tpu/evaluation/clap_scorer.py``. Weights:
``weights_path`` or ``$V2AP_CLAP_WEIGHTS`` names a model directory in the
port's ``utils/checkpoint.py`` layout (``save_model``; the published
``laion/clap-htsat-unfused`` state dict goes there through
``models.clap.load_clap_state_dict``). Without weights the scorer runs from
a seed-0 init: scores for plumbing tests, not for filtering.

Tokenizer: RoBERTa's byte-level BPE when ``tokenizer_path`` /
``$V2AP_CLAP_TOKENIZER`` names an existing Hugging Face tokenizer directory
(``data.hf_tokenizer``, called as JAX calls ``transformers``: at most 64
tokens, padded to the longest); otherwise the deterministic hash fallback
of the JAX package (stable ids; pad 1, <s> 0, </s> 2, RoBERTa's special
tokens).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from v2ap_torch.utils.device import resolve_device, seeded_init


def _fallback_tokenize(captions, vocab_size: int, max_len: int = 64):
    b = len(captions)
    ids = np.full((b, max_len), 1, np.int32)          # pad id 1
    mask = np.zeros((b, max_len), np.int32)
    for i, text in enumerate(captions):
        words = text.split()[: max_len - 2]
        ids[i, 0] = 0                                  # <s>
        for j, w in enumerate(words):
            h = int(hashlib.md5(w.lower().encode()).hexdigest(), 16)
            ids[i, j + 1] = h % (vocab_size - 3) + 3
        ids[i, len(words) + 1] = 2                     # </s>
        mask[i, : len(words) + 2] = 1
    return ids, mask


def make_clap_scorer(audio_cfg=None, text_cfg=None,
                     weights_path: Optional[str] = None,
                     tokenizer_path: Optional[str] = None, device=None):
    """-> ``scorer(wav_48k: np.ndarray, caption: str) -> float`` (cosine),
    the signature ``data.clap_filter.set_scorer`` takes. The model runs on
    ``device`` (CUDA unless asked for the CPU) in float32."""
    from v2ap_torch.models.clap import ClapModel, clap_htsat_unfused, clap_logmel

    device = resolve_device(device)
    if audio_cfg is None or text_cfg is None:
        audio_cfg, text_cfg = clap_htsat_unfused()
    tokenizer_path = tokenizer_path or os.environ.get("V2AP_CLAP_TOKENIZER")
    if tokenizer_path and os.path.exists(tokenizer_path):
        from v2ap_torch.data.hf_tokenizer import load_clap
        tokenize = load_clap(tokenizer_path)
    else:
        def tokenize(captions):
            return _fallback_tokenize(captions, text_cfg.vocab_size)
    with seeded_init(0, device):
        model = ClapModel(audio_cfg, text_cfg, device=device)
    weights_path = weights_path or os.environ.get("V2AP_CLAP_WEIGHTS")
    if weights_path:
        from v2ap_torch.utils.checkpoint import load_model
        load_model(weights_path, model)
    model.eval().requires_grad_(False)
    tmax = audio_cfg.spec_size * audio_cfg.freq_ratio

    @torch.inference_mode()
    def scorer(wav_48k: np.ndarray, caption: str) -> float:
        wav = torch.from_numpy(np.atleast_2d(
            np.asarray(wav_48k, np.float32))).to(device)
        feats = clap_logmel(wav, n_mels=audio_cfg.num_mel_bins)
        if feats.shape[2] > tmax:
            feats = feats[:, :, :tmax]             # the 10 s window
        ids, mask = tokenize([caption])
        s = model.similarity(feats, torch.from_numpy(ids).long().to(device),
                             torch.from_numpy(mask).to(device))
        return float(s[0].item())

    return scorer
