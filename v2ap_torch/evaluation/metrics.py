"""Audio quality metrics: Frechet Audio Distance (FAD), Inception Score,
paired KL divergence and CLAP similarity.

Counterpart of ``v2ap_tpu/evaluation/metrics.py``, copied: numpy in
float64 on the host, so the same embeddings and logits give the same
numbers in both packages. FAD is the Frechet distance between Gaussian
statistics of embeddings (symmetric square roots by eigendecomposition);
IS and the softmax / sigmoid KL read AudioSet logits. The embedder and
classifier default to the port's PANN Cnn14 (``evaluation/pann.py``); any
callable ``embed(waveform, sr) -> (n, d)`` can be registered instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

_EMBEDDER: Optional[Callable] = None


def set_embedder(fn: Optional[Callable]) -> None:
    global _EMBEDDER
    _EMBEDDER = fn


def embedding_stats(embeddings: np.ndarray):
    """(n, d) -> (mu (d,), sigma (d, d))."""
    mu = embeddings.mean(axis=0)
    sigma = np.cov(embeddings, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FD between two gaussians: |mu1-mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^1/2)."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    cov_prod_sqrt = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(cov_prod_sqrt))


def fad_from_embeddings(ref: np.ndarray, gen: np.ndarray) -> float:
    mu1, s1 = embedding_stats(ref)
    mu2, s2 = embedding_stats(gen)
    return frechet_distance(mu1, s1, mu2, s2)


def default_embedder() -> Callable:
    """Registers and returns the port's PANN Cnn14 embedder (weights from
    ``$V2AP_PANN_WEIGHTS`` when set, a seed-0 init otherwise), on CUDA."""
    global _EMBEDDER
    if _EMBEDDER is None:
        from v2ap_torch.evaluation.pann import make_embedder
        _EMBEDDER = make_embedder()
    return _EMBEDDER


def fad(reference_wavs: Sequence[np.ndarray], generated_wavs: Sequence[np.ndarray],
        sr: int = 24_000, embedder: Optional[Callable] = None) -> float:
    """Frechet Audio Distance between two waveform collections, with the
    built-in PANN Cnn14 embedder unless one is registered or passed."""
    fn = embedder or _EMBEDDER or default_embedder()
    ref = np.concatenate([np.atleast_2d(fn(w, sr)) for w in reference_wavs])
    gen = np.concatenate([np.atleast_2d(fn(w, sr)) for w in generated_wavs])
    return fad_from_embeddings(ref, gen)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def kl_softmax(ref_logits: np.ndarray, gen_logits: np.ndarray) -> float:
    """Paired per-clip KL(softmax(ref) || softmax(gen)) over the event
    classes, averaged over clips (AudioLDM-Eval's "KL"). ref[i] is the
    ground-truth clip of generated clip i."""
    ref_logits = np.atleast_2d(ref_logits)
    gen_logits = np.atleast_2d(gen_logits)
    if ref_logits.shape != gen_logits.shape:
        raise ValueError(f"paired KL needs matching shapes, got "
                         f"{ref_logits.shape} vs {gen_logits.shape}")
    lp_ref = _log_softmax(ref_logits)
    lp_gen = _log_softmax(gen_logits)
    return float((np.exp(lp_ref) * (lp_ref - lp_gen)).sum(axis=-1).mean())


def kl_sigmoid(ref_logits: np.ndarray, gen_logits: np.ndarray) -> float:
    """AudioLDM-Eval's "KL_Sigmoid": per-class Bernoulli KL between the
    sigmoid'ed tagging probabilities, summed over classes and averaged over
    paired clips."""
    p = 1.0 / (1.0 + np.exp(-np.atleast_2d(ref_logits)))
    q = 1.0 / (1.0 + np.exp(-np.atleast_2d(gen_logits)))
    eps = 1e-7
    p = np.clip(p, eps, 1 - eps)
    q = np.clip(q, eps, 1 - eps)
    kl = p * np.log(p / q) + (1 - p) * np.log((1 - p) / (1 - q))
    return float(kl.sum(axis=-1).mean())


def inception_score(gen_logits: np.ndarray, splits: int = 10):
    """exp(E_x KL(p(y|x) || p(y))) per split over the softmax
    distributions -> (mean, std); ``splits`` is clamped to the clips."""
    probs = np.exp(_log_softmax(np.atleast_2d(gen_logits)))
    n = probs.shape[0]
    splits = max(1, min(splits, n))
    scores = []
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(marginal + 1e-12)))
        scores.append(float(np.exp(kl.sum(axis=-1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def default_classifier() -> Callable:
    from v2ap_torch.evaluation.pann import make_classifier
    return make_classifier()


def audioldm_eval_metrics(reference_wavs: Sequence[np.ndarray],
                          generated_wavs: Sequence[np.ndarray],
                          sr: int = 24_000,
                          embedder: Optional[Callable] = None,
                          classifier: Optional[Callable] = None,
                          paired: Optional[bool] = None) -> dict:
    """The AudioLDM-Eval metric set: FAD (Cnn14 embeddings), Inception
    Score, and for paired collections (same length, or ``paired=True``)
    the softmax and sigmoid KL on Cnn14's tagging logits. With no embedder
    or classifier given or registered, one Cnn14 pass per clip
    (``pann.make_joint``) serves them all."""
    if paired is None:
        paired = len(reference_wavs) == len(generated_wavs)

    if embedder is None and classifier is None and _EMBEDDER is None:
        from v2ap_torch.evaluation.pann import make_joint
        joint = make_joint()

        def run_all(wavs):
            outs = [joint(w, sr) for w in wavs]
            return (np.concatenate([np.atleast_2d(e) for e, _ in outs]),
                    np.concatenate([np.atleast_2d(l) for _, l in outs]))

        ref_emb, ref_logits = run_all(reference_wavs)
        gen_emb, gen_logits = run_all(generated_wavs)
        out = {"fad": fad_from_embeddings(ref_emb, gen_emb)}
    else:
        cls = classifier or default_classifier()
        out = {"fad": fad(reference_wavs, generated_wavs, sr,
                          embedder=embedder)}
        gen_logits = np.concatenate(
            [np.atleast_2d(cls(w, sr)) for w in generated_wavs])
        ref_logits = (np.concatenate(
            [np.atleast_2d(cls(w, sr)) for w in reference_wavs])
            if paired else None)

    is_mean, is_std = inception_score(gen_logits)
    out["is_mean"], out["is_std"] = is_mean, is_std
    if paired:
        out["kl_softmax"] = kl_softmax(ref_logits, gen_logits)
        out["kl_sigmoid"] = kl_sigmoid(ref_logits, gen_logits)
    return out


def clap_similarity(waveform: np.ndarray, sr: int, caption: str) -> Optional[float]:
    """Text-audio CLAP score through the scorer registry
    (``data.clap_filter``); None when no scorer is registered."""
    from v2ap_torch.data import clap_filter
    return clap_filter.score(waveform[None] if waveform.ndim == 1 else waveform,
                             sr, caption)
