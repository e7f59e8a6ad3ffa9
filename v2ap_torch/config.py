"""Typed configuration for the PyTorch port.

A copy of the fields of ``v2ap_tpu.config`` that the port's V2A serving
slice reads (the port imports nothing of the JAX package). The field names,
defaults and meanings are the JAX package's, so one configuration drives both.
``ModelConfig.dtype`` is the compute dtype: matmul inputs are cast to it,
parameters stay float32, norms and softmax run in float32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Tri-stream CFM transformer (reference: e2_tts_crossatt3.py:707-1143,1275-1523)."""

    # audio stream
    dim: int = 1024
    depth: int = 12
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    # text (CLIP-frame) stream
    dim_text: int = 1280
    text_heads: int = 16
    text_dim_head: int = 64
    text_ff_mult: int = 4
    text_depth: int = 12
    # frames (piano-roll) stream
    dim_frames: int = 512
    frames_heads: int = 8
    frames_dim_head: int = 64
    frames_ff_mult: int = 4
    # positional / conv modules
    max_seq_len: int = 8192
    kernel_size: int = 31
    num_registers: int = 32
    abs_pos_emb: bool = True
    if_audio_conv: bool = True
    if_text_conv: bool = True
    if_cross_attn: bool = True
    # attention options
    gate_value_heads: bool = True
    softclamp_logits: bool = True
    softclamp_value: float = 50.0
    dropout: float = 0.1
    # latent space
    num_channels: int = 128          # EnCodec latent channels
    notes: int = 51                  # piano-roll keys
    note_min: int = 15
    note_max: int = 65
    video2roll: bool = True
    dim_text_raw: Optional[int] = None
    # conditioning projections
    if_cond_proj_in: bool = True
    cond_proj_in_bias: bool = True
    concat_cond: bool = False
    # T5 cross-attention context width (flan-t5-large hidden size)
    dim_context: int = 1024
    # compute dtypes
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # training-only in the JAX package; kept so one config drives both
    remat: bool = False
    remat_policy: str = "full"
    # every audio layer's time-cond projections as one stacked matmul
    fused_adaln: bool = True

    @property
    def video_multi(self) -> float:
        return 3.0 if self.notes == 51 else 2.5


@dataclass(frozen=True)
class SamplerConfig:
    """Euler ODE sampling (reference: e2_tts_crossatt3.py:2128-2256)."""

    steps: int = 25
    cfg_strength: float = 2.0
    sway_sampling: bool = True
    remove_parallel_component: bool = False
    keep_parallel_frac: float = 0.0
    max_duration: int = 4096
    method: str = "euler"            # euler | midpoint | heun


@dataclass(frozen=True)
class ConditioningConfig:
    """Frozen encoder stack (reference: e2_tts_crossatt3.py:1411-1523)."""

    text_encoder: str = "flan-t5-large"
    video_encoder: str = "clip_vit"
    sampling_rate: int = 24_000
    frame_size: int = 320                      # latent hop: 75 Hz at 24 kHz
    audiocond_drop_prob: float = 1.1
    cond_drop_prob: float = 0.2
    prompt_drop_prob: float = 0.1
    frac_lengths_mask: Tuple[float, float] = (0.7, 1.0)
    audiocond_snr: Optional[Tuple[float, float]] = None
    feature_cache: bool = True
    frame_stride: int = 3
    piano_frame_h: int = 100
    piano_frame_w: int = 900
    piano_window: int = 5
    strip_stride: int = 2


@dataclass(frozen=True)
class V2APConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    conditioning: ConditioningConfig = field(default_factory=ConditioningConfig)

    def replace(self, **sections: Any) -> "V2APConfig":
        return dataclasses.replace(self, **sections)


def v2a_default() -> V2APConfig:
    """The shipped V2A/V2P config (reference: src/inference_v2a.py:74-111)."""
    return V2APConfig()


def tiny_test() -> V2APConfig:
    """A CPU-runnable miniature for unit tests."""
    cfg = V2APConfig()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model,
            dim=64, depth=4, heads=2, dim_head=32,
            dim_text=48, text_heads=2, text_dim_head=32, text_depth=4,
            dim_frames=32, frames_heads=2, frames_dim_head=16,
            max_seq_len=256, kernel_size=7, num_registers=4,
            num_channels=16, notes=51, dim_context=32,
            dtype="float32",
        ),
        sampler=dataclasses.replace(cfg.sampler, steps=4),
        conditioning=dataclasses.replace(cfg.conditioning, frame_stride=1,
                                         strip_stride=1),
    )
