"""End-to-end video-to-audio generation pipeline (V2A, empty prompt).

Counterpart of ``v2ap_tpu/pipelines/generate.py`` for the serving slice the
port covers so far:

  host:   video decode (cv2), or frames handed in through ``frames_cache``
  device: CLIP ViT-bigG over every decoded frame, in chunks     [K2 kernel]
  device: 25-step sway-Euler CFM sampling, CFG batch-doubled    [K1 kernel]
  device: EnCodec decode

What later slices add raises ``NotImplementedError`` here rather than give
a different result: a non-empty prompt (T5), ``piano=True`` (Video2Roll),
``passes > 1``, int8 towers, a frame stride above 1, and the on-disk
feature caches. The port reads no environment variables.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from v2ap_torch.config import SamplerConfig, V2APConfig
from v2ap_torch.data import video_io
from v2ap_torch.models.cfm import CFM
from v2ap_torch.models.clip_vit import device_normalize
from v2ap_torch.models.encodec import EncodecConfig, EncodecModel
from v2ap_torch.models.video_towers import build_video_towers
from v2ap_torch.utils.device import resolve_device, seeded_init


def bucket_length(n: int, bucket: int = 96) -> int:
    """Round up to a multiple of 96 latent frames (the JAX package's shape
    buckets; the port's kernels take any length)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


class FallbackTokenizer:
    """Deterministic hash tokenizer (ids stable across processes), the one
    the JAX package uses when no sentencepiece assets are present."""

    def __init__(self, vocab_size: int, max_len: int = 64):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __call__(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        b = len(prompts)
        ids = np.zeros((b, self.max_len), np.int32)
        mask = np.zeros((b, self.max_len), np.int32)
        for i, p in enumerate(prompts):
            words = p.split()[: self.max_len - 1]
            for j, w in enumerate(words):
                h = int(hashlib.md5(w.lower().encode()).hexdigest(), 16)
                ids[i, j] = h % (self.vocab_size - 2) + 1
            ids[i, len(words)] = 1            # eos
            mask[i, : len(words) + 1] = 1
        return ids, mask


class V2APipeline:
    """Owns the model stack on one device (``device=None`` means CUDA)."""

    def __init__(self, cfg: V2APConfig | None = None, *, seed: int = 0,
                 device=None, clip_config=None, encodec_config=None,
                 quantize_towers: Optional[bool] = None,
                 quantize_cfm: Optional[bool] = None):
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or V2APConfig()
        if quantize_towers or quantize_cfm:
            raise NotImplementedError("int8 towers / CFM are not ported yet; "
                                      "the port serves bf16 towers")
        if cfg.conditioning.frame_stride != 1:
            raise NotImplementedError(
                "frame_stride > 1 (lerped conditioning) is not ported yet; "
                "use ConditioningConfig(frame_stride=1)")
        if cfg.conditioning.feature_cache:
            raise NotImplementedError(
                "on-disk feature caches are not ported yet; use "
                "ConditioningConfig(feature_cache=False)")
        if encodec_config is None:
            encodec_config = EncodecConfig()
            if cfg.model.num_channels != encodec_config.hidden_size:
                # miniature configs: shrink the codec to the latent width
                encodec_config = EncodecConfig(
                    hidden_size=cfg.model.num_channels, num_filters=4,
                    upsampling_ratios=(8, 5, 4, 2), num_lstm_layers=1)
        self.codec_cfg = encodec_config

        # parameter init draws from the seed, on the device (bigG in f32 on
        # the host would take minutes to initialise)
        with seeded_init(seed, self.device):
            self.cfm = CFM(cfg.model, cfg.conditioning, device=self.device)
        with seeded_init(seed + 1, self.device):
            self.codec = EncodecModel(encodec_config, device=self.device)
        self.towers = build_video_towers(cfg.conditioning.video_encoder,
                                         seed=seed + 3,
                                         clip_config=clip_config,
                                         device=self.device)
        self.clip = self.towers[0].model
        self.clip_cfg = self.clip.cfg
        # frozen towers are stored bf16 when the model computes in bf16
        if cfg.model.dtype == "bfloat16":
            for tower in self.towers:
                tower.model.to(torch.bfloat16)
        for module in (self.cfm, self.codec, *(t.model for t in self.towers)):
            module.eval().requires_grad_(False)
        self.last_timings: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ conditioning
    def _encode_tower(self, tower, video_path: Optional[str], chunk: int,
                      frames_cache: list):
        """One tower's per-frame embeddings (on the device) and the clip's
        duration; decodes the video into ``frames_cache`` unless it already
        holds (frames, duration, step)."""
        if not frames_cache:
            frames_cache.append(video_io.read_video_frames(video_path) + (1,))
        frames, duration, step = frames_cache[0]
        if frames is None:
            return None, None
        if step != 1:
            raise NotImplementedError(
                f"frames_cache holds every {step}th frame; the port encodes "
                "every frame (frame stride 1)")
        px = tower.preprocess(frames)                 # uint8 geometry only
        feats = [tower.model(device_normalize(
                     torch.from_numpy(px[i: i + chunk]).to(self.device),
                     tower.mean, tower.std))
                 for i in range(0, len(px), chunk)]
        return torch.cat(feats), duration

    @torch.inference_mode()
    def encode_video_frames_clip(self, video_path: Optional[str], length: int,
                                 chunk: Optional[int] = None,
                                 frames_cache=None):
        """Per-frame tower embeddings interpolated to the latent rate
        (nearest frame), zero-padded to ``length`` rows: ((length, dim)
        float32 on the device, duration)."""
        chunk = chunk or 64
        frames_cache = [] if frames_cache is None else frames_cache
        feats, duration = self._encode_tower(self.towers[0], video_path, chunk,
                                             frames_cache)
        if feats is None:
            return None, None
        idx = video_io.interp_indices_clip(
            len(feats), duration, length,
            sample_rate=self.cfg.conditioning.sampling_rate,
            frame_size=self.cfg.conditioning.frame_size)
        interp = feats[torch.from_numpy(idx).to(self.device)]
        if len(interp) < length:
            interp = torch.cat([interp, interp.new_zeros(
                length - len(interp), interp.shape[-1])])
        return interp.float(), duration

    # ---------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(
        self,
        video_path: Optional[str],
        prompt: str = "",
        *,
        duration_s: Optional[float] = None,
        steps: int = 25,
        cfg_strength: float = 2.0,
        piano: bool = False,
        seed: int = 0,
        max_duration_s: float = 30.0,
        passes: int = 1,
        fewstep: Optional[int] = None,
        frames_cache: Optional[list] = None,
    ) -> Tuple[np.ndarray, int]:
        """Silent video -> generated waveform @ 24 kHz.

        The video arrives as a path, or already decoded as
        ``frames_cache=[(uint8 (t, H, W, 3) frames, duration_s, 1)]``. The
        empty prompt becomes a zero context of length 1 (the reference's
        dropped prompt). ``fewstep=N`` runs N uniform Euler steps without CFG
        (the distilled-student mode). ``x0`` is drawn from a
        ``torch.Generator`` seeded with ``seed``.
        """
        if prompt.strip():
            raise NotImplementedError("prompts (T5 context) are not ported "
                                      "yet; pass an empty prompt")
        if piano:
            raise NotImplementedError("piano=True (Video2Roll) is not ported yet")
        if passes > 1:
            raise NotImplementedError("passes > 1 (sample_multipass) is not "
                                      "ported yet")
        dev = self.device
        cond = self.cfg.conditioning
        sr = cond.sampling_rate
        timings = {}
        t0 = time.perf_counter()

        def plan_length(dur_s):
            """(duration_s, n_valid, n) under the abs-pos ceiling."""
            max_n = ((self.cfg.model.max_seq_len
                      - self.cfg.model.num_registers) // 96) * 96
            nv = min(int(round(dur_s * sr / cond.frame_size)), max_n)
            return (min(dur_s, nv * cond.frame_size / sr), nv,
                    min(bucket_length(nv), max_n))

        text_embed, video_duration = None, None
        if video_path is not None or frames_cache:
            probe_len = int(max_duration_s * sr / cond.frame_size)
            text_embed, video_duration = self.encode_video_frames_clip(
                video_path, probe_len, frames_cache=frames_cache)
        self._sync()
        timings["video_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if duration_s is None:
            duration_s, n_valid, n = plan_length(
                min(video_duration or 10.0, max_duration_s))
        else:
            duration_s, n_valid, n = plan_length(duration_s)

        b = 1
        tdim = self.cfg.model.dim_text_raw or self.cfg.model.dim_text
        text = torch.zeros(b, n, tdim, device=dev)
        if text_embed is not None:
            m = min(n, len(text_embed))
            text[0, :m] = text_embed[:m]
        # empty prompt: the T5 k/v projections carry no bias, so a zero
        # context of length 1 equals the zeroed encoder output
        ctx = torch.zeros(b, 1, self.cfg.model.dim_context, device=dev)
        ctx_mask = torch.ones(b, 1, dtype=torch.bool, device=dev)
        frames_roll = torch.zeros(b, n, self.cfg.model.notes, device=dev)
        mask = torch.arange(n, device=dev)[None, :] < n_valid
        gen = torch.Generator(device=dev).manual_seed(seed)
        x0 = torch.randn(b, n, self.cfg.model.num_channels, generator=gen,
                         device=dev)
        timings["conditioning_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if fewstep:
            sampler = SamplerConfig(steps=fewstep, cfg_strength=0.0,
                                    sway_sampling=False)
        else:
            sampler = SamplerConfig(steps=steps, cfg_strength=cfg_strength,
                                    sway_sampling=True)
        latents = self.cfm.sample(x0, text_embed=text, frames_embed=frames_roll,
                                  context=ctx, context_mask=ctx_mask,
                                  mask=mask, sampler=sampler)
        self._sync()
        timings["sample_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wav = self.codec.decode(latents[:, :n_valid]).cpu().numpy()
        timings["decode_s"] = time.perf_counter() - t0
        self.last_timings = timings
        return wav[0, : int(duration_s * sr)], sr
