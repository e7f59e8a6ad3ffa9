"""Typed configuration for the PyTorch port.

A copy of ``v2ap_tpu.config`` (the port imports nothing of the JAX
package). The field names, defaults and meanings are the JAX package's, so
one configuration drives both, and ``V2APConfig.from_json`` reads what the
JAX package's ``to_json`` writes, its ``mesh`` section included
(``MeshConfig``: the data x model process mesh of ``v2ap_torch.parallel``).
``ModelConfig.dtype`` is the compute dtype: matmul inputs are cast to it,
parameters stay float32, norms and softmax run in float32.
"""

from __future__ import annotations

import dataclasses
import json
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
    # per-layer activation recomputation in training: "full" recomputes
    # every activation of a tri-stream layer, "dots" saves the outputs of
    # products without batch dimensions and recomputes the rest
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


def fewstep_sampler(steps: int = 2) -> SamplerConfig:
    """Sampler settings for a reflow-distilled student
    (``training.distill``): ``steps`` uniform Euler steps without CFG (the
    guidance is in the pairs) and without sway (the straightened flow wants
    uniform timesteps); ``V2APipeline.generate(fewstep=steps)`` samples
    with it."""
    return SamplerConfig(steps=steps, cfg_strength=0.0, sway_sampling=False)


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
class DataConfig:
    """Training data pipeline (``v2ap_torch.data.dataset.TrainBatcher``)."""

    target_length: int = 750                   # 10 s of 75 Hz latents
    min_target_length: int = 750
    hop_size: int = 320
    sample_rate: int = 24_000
    oversample_multi: int = 4                  # candidate oversampling factor
    keep_last: int = 5                         # rows kept per oversampled batch
    theta_ratio: float = 0.5                   # SE / non-SE corpus resampling ratio
    clap_filter: bool = False
    mix_augment: bool = True
    num_workers: int = 8
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """The data x model mesh of ``v2ap_torch.parallel.make_mesh``: one rank
    per device, ``data_parallel`` rows (-1: every rank over
    ``model_parallel``) of ``model_parallel`` tensor-parallel ranks."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1                     # -1 == all ranks
    model_parallel: int = 1


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 7.5e-5
    warmup_steps: int = 20_000
    decay_steps: int = 1_000_000
    grad_accum: int = 1
    grad_clip: float = 1.0
    batch_size: int = 8
    epochs: int = 10
    save_step: int = 2000
    midi_loss_weight: float = 10.0             # weight of the V2P MIDI loss
    mu_bf16: bool = False                      # bf16 AdamW first moment
    ema_decay: float = 0.999
    use_ema: bool = False
    switch_ema_every: int = 0                  # >0: TrainingPipeline.fit copies EMA -> model every N steps
    # DPO preference optimization against the EMA shadow (turns EMA on)
    dpo: bool = False
    dpo_beta: float = 1.0
    velocity_consistency_weight: float = -1e-5
    # FactorCL contrastive alignment (the crossatt6 variant)
    contrastive: bool = False
    contrastive_weight: float = 1.0
    contrastive_layer: int = 1


@dataclass(frozen=True)
class V2APConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    conditioning: ConditioningConfig = field(default_factory=ConditioningConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "V2APConfig":
        def build(klass, sub):
            fields = {f.name for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {klass.__name__}.{k}")
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            return klass(**kwargs)

        unknown = set(d) - {"model", "sampler", "conditioning", "data",
                            "mesh", "train"}
        if unknown:
            raise KeyError(f"unknown config sections {sorted(unknown)}")
        return cls(
            model=build(ModelConfig, d.get("model", {})),
            sampler=build(SamplerConfig, d.get("sampler", {})),
            conditioning=build(ConditioningConfig, d.get("conditioning", {})),
            data=build(DataConfig, d.get("data", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
            train=build(TrainConfig, d.get("train", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "V2APConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **sections: Any) -> "V2APConfig":
        return dataclasses.replace(self, **sections)


def v2a_default() -> V2APConfig:
    """The shipped V2A/V2P config (reference: src/inference_v2a.py:74-111)."""
    return V2APConfig()


def v2p_88key() -> V2APConfig:
    """88-key full-keyboard variant (reference: e2_tts_crossatt3_2.py:74-76)."""
    cfg = V2APConfig()
    return cfg.replace(model=dataclasses.replace(cfg.model, notes=88,
                                                 note_min=0, note_max=87))


VARIANTS = ("crossatt", "crossatt6", "crossatt3", "crossatt3_2")


def variant_preset(name: str) -> V2APConfig:
    """One config per model variant, as the JAX package's:
    ``crossatt`` (no piano-roll stream or Video2Roll), ``crossatt6``
    (+ FactorCL), ``crossatt3`` (the shipped V2A + V2P model) and
    ``crossatt3_2`` (88 keys)."""
    cfg = V2APConfig()
    if name == "crossatt":
        return cfg.replace(
            model=dataclasses.replace(cfg.model, video2roll=False))
    if name == "crossatt6":
        return cfg.replace(
            model=dataclasses.replace(cfg.model, video2roll=False),
            train=dataclasses.replace(cfg.train, contrastive=True))
    if name == "crossatt3":
        return cfg
    if name == "crossatt3_2":
        return v2p_88key()
    raise ValueError(f"unknown variant {name!r}; expected one of {VARIANTS}")


def tiny_tower_test() -> V2APConfig:
    """tiny_test with stream widths matched to the tiny frozen towers
    (``t5_tiny_test`` d_model 32, ``clip_tiny_test`` projection 16), the
    config of the CPU-runnable ``--tiny`` entry points; training windows
    shrink to fit the tiny max_seq_len."""
    cfg = tiny_test()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, dim_text=16, dim_context=32, num_channels=8),
        data=dataclasses.replace(cfg.data, target_length=96,
                                 min_target_length=96))


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


def dryrun_test() -> V2APConfig:
    """tiny_test at depth 2 (one U-Net down / up pair): the config of the
    multichip dry run (``python -m v2ap_torch.parallel.dryrun``)."""
    cfg = tiny_test()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, depth=2, text_depth=2))
