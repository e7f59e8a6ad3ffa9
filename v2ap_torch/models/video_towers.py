"""Per-frame video-encoder registry.

Counterpart of ``v2ap_tpu/models/video_towers.py`` for the ``clip_vit`` mode
(CLIP ViT-bigG, 1280-d); the other towers and the mixed mode are not ported
yet. Each tower carries its own host preprocessing (geometry only, uint8)
and the normalisation constants applied on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
from torch import nn

from v2ap_torch.models.clip_vit import (
    CLIP_MEAN, CLIP_STD, CLIPVisionConfig, CLIPVisionModel, clip_vit_bigg,
    preprocess_frames,
)
from v2ap_torch.utils.device import resolve_device, seeded_init


@dataclasses.dataclass
class VideoTower:
    name: str
    model: nn.Module
    preprocess: Callable[[np.ndarray], np.ndarray]   # geometry only -> uint8
    embed_dim: int
    mean: tuple               # normalisation applied on the device
    std: tuple


def build_video_towers(video_encoder: str, *, seed: int = 0,
                       clip_config: Optional[CLIPVisionConfig] = None,
                       device=None) -> List[VideoTower]:
    """The tower list for a ``ConditioningConfig.video_encoder`` value, with
    parameters initialised from ``seed`` on ``device``. ``clip_config``
    replaces ViT-bigG's config (tiny test configs)."""
    if video_encoder != "clip_vit":
        raise NotImplementedError(
            f"video_encoder {video_encoder!r} is not ported yet; the port "
            "builds the 'clip_vit' tower only")
    device = resolve_device(device)
    cfg = clip_config or clip_vit_bigg()
    with seeded_init(seed, device):
        model = CLIPVisionModel(cfg, device=device)
    return [VideoTower(
        name="clip_vit", model=model,
        preprocess=lambda frames: preprocess_frames(
            frames, cfg.image_size, normalize=False),
        embed_dim=cfg.projection_dim, mean=CLIP_MEAN, std=CLIP_STD)]
