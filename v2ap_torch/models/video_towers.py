"""Per-frame video-encoder registry: every ``video_encoder`` mode of the
reference, the 4-tower "mixed" concat included.

Counterpart of ``v2ap_tpu/models/video_towers.py``:

| mode          | tower(s)                               | embed dim |
|---------------|----------------------------------------|-----------|
| clip_vit      | CLIP ViT-bigG (IP-Adapter SDXL)        | 1280      |
| clip_vit2     | CLIP ViT-L/14-336                      | 768       |
| clip_convnext | open_clip ConvNeXt-XXLarge             | 1024      |
| dinov2        | DINOv2-giant (pooler_output)           | 1536      |
| mixed         | concat of all four -> CFM ``proj_text``| 4608      |

Each tower carries its own geometry (uint8 frames resized and cropped to its
image size, 224, 336, 256 or 224, on their device, bit-equal to PIL's; or on
the host through the host library, for the YUV wire) and the normalisation
constants applied after it (CLIP's, ImageNet's for DINOv2).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from v2ap_torch.models.clip_vit import (
    CLIP_MEAN, CLIP_STD, CLIPVisionModel, clip_vit_bigg, clip_vit_l_336,
    crop_to_tower, host_crop_to_tower,
)
from v2ap_torch.models.convnext import ConvNextCLIP, convnext_xxlarge
from v2ap_torch.models.dinov2 import (
    IMAGENET_MEAN, IMAGENET_STD, Dinov2Model, dinov2_giant,
)
from v2ap_torch.utils.device import resolve_device, seeded_init


@dataclasses.dataclass
class VideoTower:
    name: str                 # cache-file suffix, as the JAX package's
    model: nn.Module
    # uint8 (t, H, W, 3) -> uint8 (t, S, S, 3), geometry only, on the
    # frames' device
    preprocess: Callable[[torch.Tensor], torch.Tensor]
    # the same geometry on numpy frames on the host, through the host
    # library (the YUV wire's route), bit-equal to ``preprocess``
    host_preprocess: Callable[[np.ndarray], np.ndarray]
    embed_dim: int
    mean: tuple               # normalisation applied after the geometry
    std: tuple


VALID_ENCODERS = ("clip_vit", "clip_vit2", "clip_convnext", "dinov2", "mixed")


def mixed_embed_dim(overrides: Optional[dict] = None) -> int:
    return sum(spec[2] for spec in _tower_specs(overrides).values())


def _tower_specs(overrides: Optional[dict] = None) -> dict:
    """name -> (config, model class, embed_dim, preprocess kwargs)."""
    o = overrides or {}

    def spec(name, default_cfg, model_cls, mean, std, dim_attr):
        cfg = o.get(name, default_cfg())
        return (cfg, model_cls, getattr(cfg, dim_attr),
                dict(image_size=cfg.image_size, mean=mean, std=std))

    return {
        "clip_vit": spec("clip_vit", clip_vit_bigg, CLIPVisionModel,
                         CLIP_MEAN, CLIP_STD, "projection_dim"),
        "clip_vit2": spec("clip_vit2", clip_vit_l_336, CLIPVisionModel,
                          CLIP_MEAN, CLIP_STD, "projection_dim"),
        "clip_convnext": spec("clip_convnext", convnext_xxlarge, ConvNextCLIP,
                              CLIP_MEAN, CLIP_STD, "embed_dim"),
        "dinov2": spec("dinov2", dinov2_giant, Dinov2Model,
                       IMAGENET_MEAN, IMAGENET_STD, "hidden_size"),
    }


def build_video_towers(video_encoder: str, *, seed: int = 0,
                       overrides: Optional[dict] = None,
                       device=None) -> List[VideoTower]:
    """The tower list for a ``ConditioningConfig.video_encoder`` value, tower
    i's parameters initialised from ``seed + i`` on ``device``.
    ``overrides`` maps a tower name to its config (tiny test configs)."""
    if video_encoder not in VALID_ENCODERS:
        raise ValueError(f"video_encoder {video_encoder!r} not one of "
                         f"{VALID_ENCODERS}")
    device = resolve_device(device)
    specs = _tower_specs(overrides)
    names = list(specs) if video_encoder == "mixed" else [video_encoder]
    towers = []
    for i, name in enumerate(names):
        cfg, model_cls, dim, pre_kw = specs[name]
        with seeded_init(seed + i, device):
            model = model_cls(cfg, device=device)
        towers.append(VideoTower(
            name=name, model=model,
            preprocess=functools.partial(crop_to_tower,
                                         image_size=pre_kw["image_size"]),
            host_preprocess=functools.partial(
                host_crop_to_tower, image_size=pre_kw["image_size"]),
            embed_dim=dim, mean=tuple(pre_kw["mean"]),
            std=tuple(pre_kw["std"])))
    return towers
