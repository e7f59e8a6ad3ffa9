"""Rotary position embeddings (GPT-NeoX half-split flavor).

Counterpart of ``v2ap_tpu/ops/rope.py``: ``inv_freq = base^(-2i/d)``,
frequencies duplicated across both halves, the rotation applied in float32
and cast back to the input dtype. Rotary goes on q/k of self-attention only.
"""

from __future__ import annotations

import torch


def rope_table(seq_len: int, dim: int, base: float = 10_000.0,
               device=None) -> torch.Tensor:
    """Angles per position and feature, shape (seq_len, dim), float32."""
    if dim % 2:
        raise ValueError(f"rotary dim must be even, got {dim}")
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                    # (n, dim/2)
    return torch.cat([freqs, freqs], dim=-1)            # (n, dim)


def apply_rope(t: torch.Tensor, freqs: torch.Tensor,
               seq_axis: int = -2) -> torch.Tensor:
    """Rotate the last dim of ``t`` by ``freqs`` (n, d); the sequence dim of
    ``t`` is ``seq_axis`` (-2 for (..., n, d); 1 for (b, n, h, d)).

    A head dim wider than the table leaves its tail unrotated (partial
    rotary); a table longer than the sequence contributes its *last*
    seq_len rows.
    """
    rot_dim = freqs.shape[-1]
    sa = seq_axis % t.dim()
    seq_len = t.shape[sa]
    half = rot_dim // 2
    freqs_h = freqs[-seq_len:, :half]
    if sa != t.dim() - 2:                    # broadcast across dims after seq
        freqs_h = freqs_h.reshape((seq_len,) + (1,) * (t.dim() - 2 - sa)
                                  + (half,))
    dtype = t.dtype
    x1 = t[..., :half].float()
    x2 = t[..., half:rot_dim].float()
    cos, sin = torch.cos(freqs_h), torch.sin(freqs_h)
    o1 = (x1 * cos - x2 * sin).to(dtype)
    o2 = (x2 * cos + x1 * sin).to(dtype)
    return torch.cat([o1, o2, t[..., rot_dim:]], dim=-1)
