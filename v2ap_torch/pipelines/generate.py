"""End-to-end generation pipeline: a silent video, and optionally a text
prompt, to audio (V2A) or piano music (V2P).

Counterpart of ``v2ap_tpu/pipelines/generate.py``:

  host:   video decode (cv2), or frames handed in through ``frames_cache``;
          for V2P also grayscale keyboard strips, decoded in the same pass
          or handed in through ``strips_cache``
  device: CLIP ViT-bigG over every ``frame_stride``-th frame, in chunks,
          blended linearly to the latent rate                   [K2 kernel]
  device: FLAN-T5 over a non-empty prompt (plain PyTorch attention)
  device: Video2Roll over 5-strip windows, the strips blended from every
          ``strip_stride``-th one (V2P)
  device: 25-step sway-Euler CFM sampling, CFG batch-doubled    [K1 kernel]
  device: EnCodec decode

What is not ported yet raises ``NotImplementedError`` here rather than give
a different result: a tokenizer path (the sentencepiece assets),
``passes > 1``, int8 towers and the on-disk feature caches. The port reads no
environment variables.
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
from v2ap_torch.models.t5 import T5Encoder, flan_t5_large
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
                 device=None, tokenizer_path: Optional[str] = None,
                 t5_config=None, clip_config=None, encodec_config=None,
                 quantize_towers: Optional[bool] = None,
                 quantize_cfm: Optional[bool] = None):
        if tokenizer_path is not None:
            raise NotImplementedError(
                "tokenizer_path: the sentencepiece / HF tokenizer assets are "
                "not supported yet; prompts go through FallbackTokenizer, "
                "the JAX package's tokenizer when no assets are present")
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or V2APConfig()
        cond = cfg.conditioning
        if quantize_towers or quantize_cfm:
            raise NotImplementedError("int8 towers / CFM are not ported yet; "
                                      "the port serves bf16 towers")
        if cond.feature_cache:
            raise NotImplementedError(
                "on-disk feature caches are not ported yet; use "
                "ConditioningConfig(feature_cache=False)")
        # encode every frame_stride-th frame and blend between them; keyboard
        # strips likewise at strip_stride (1 = the reference's every frame)
        self.frame_stride = max(1, cond.frame_stride)
        self.strip_stride = max(1, cond.strip_stride)
        if encodec_config is None:
            encodec_config = EncodecConfig()
            if cfg.model.num_channels != encodec_config.hidden_size:
                # miniature configs: shrink the codec to the latent width
                encodec_config = EncodecConfig(
                    hidden_size=cfg.model.num_channels, num_filters=4,
                    upsampling_ratios=(8, 5, 4, 2), num_lstm_layers=1)
        self.codec_cfg = encodec_config
        self.t5_cfg = t5_config or flan_t5_large()

        # parameter init draws from the seed, on the device (bigG in f32 on
        # the host would take minutes to initialise)
        with seeded_init(seed, self.device):
            self.cfm = CFM(cfg.model, cond, device=self.device,
                           with_video2roll=cfg.model.video2roll)
        with seeded_init(seed + 1, self.device):
            self.codec = EncodecModel(encodec_config, device=self.device)
        with seeded_init(seed + 2, self.device):
            self.t5 = T5Encoder(self.t5_cfg, device=self.device)
        self.towers = build_video_towers(cond.video_encoder, seed=seed + 3,
                                         clip_config=clip_config,
                                         device=self.device)
        self.clip = self.towers[0].model
        self.clip_cfg = self.clip.cfg
        # frozen encoders are stored bf16 when the model computes in bf16
        if cfg.model.dtype == "bfloat16":
            for model in (self.t5, *(t.model for t in self.towers)):
                model.to(torch.bfloat16)
        for module in (self.cfm, self.codec, self.t5,
                       *(t.model for t in self.towers)):
            module.eval().requires_grad_(False)
        self.tokenize = FallbackTokenizer(self.t5_cfg.vocab_size)
        self.last_timings: dict = {}
        self.last_roll: Optional[torch.Tensor] = None   # (n, notes), V2P

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ conditioning
    @torch.inference_mode()
    def encode_text(self, prompts: Sequence[str]):
        """Prompts -> (T5 hidden states (b, 64, d_model) in T5's dtype, bool
        mask (b, 64)) on the device; padded rows are zero."""
        ids, mask = self.tokenize(list(prompts))
        mask = self._to_device(mask).bool()
        return self.t5(self._to_device(ids).long(), mask), mask

    def _encode_tower(self, tower, video_path: Optional[str], chunk: int,
                      frames_cache: list):
        """One tower's embeddings of every ``frame_stride``-th frame (on the
        device) and the clip's duration. Decodes the video into
        ``frames_cache`` unless it already holds (frames, duration, step),
        with step 1 (full rate) or the frame stride."""
        stride = self.frame_stride
        if not frames_cache:
            frames_cache.append(video_io.read_video_frames(video_path,
                                                           step=stride)
                                + (stride,))
        frames, duration, step = frames_cache[0]
        if frames is None:
            return None, None
        if step not in (1, stride):
            raise ValueError(f"frames_cache holds every {step}th frame; the "
                             f"pipeline takes full-rate frames or every "
                             f"{stride}th (its frame_stride)")
        if stride > 1 and step == 1:
            frames = frames[::stride]
        px = tower.preprocess(frames)                 # uint8 geometry only
        feats = [tower.model(device_normalize(
                     self._to_device(px[i: i + chunk]), tower.mean, tower.std))
                 for i in range(0, len(px), chunk)]
        return torch.cat(feats), duration

    @torch.inference_mode()
    def encode_video_frames_clip(self, video_path: Optional[str], length: int,
                                 chunk: Optional[int] = None,
                                 frames_cache=None):
        """Tower embeddings at the latent rate, zero-padded to ``length``
        rows: ((length, dim) float32 on the device, duration). At frame
        stride 1 each row takes its nearest frame; above 1 it blends the two
        nearest encoded frames in float32."""
        chunk = chunk or 64
        frames_cache = [] if frames_cache is None else frames_cache
        feats, duration = self._encode_tower(self.towers[0], video_path, chunk,
                                             frames_cache)
        if feats is None:
            return None, None
        cond = self.cfg.conditioning
        kw = dict(sample_rate=cond.sampling_rate, frame_size=cond.frame_size)
        feats = feats.float()
        if self.frame_stride > 1:
            i0, i1, w = video_io.interp_weights_clip(len(feats), duration,
                                                     length, **kw)
            wcol = self._to_device(w)[:, None]
            interp = (feats[self._to_device(i0)] * (1.0 - wcol)
                      + feats[self._to_device(i1)] * wcol)
        else:
            idx = video_io.interp_indices_clip(len(feats), duration, length,
                                               **kw)
            interp = feats[self._to_device(idx)]
        if len(interp) < length:
            interp = torch.cat([interp, interp.new_zeros(
                length - len(interp), interp.shape[-1])])
        return interp, duration

    def encode_piano_frames(self, video_path: Optional[str], length: int,
                            frames_cache=None, strips_cache=None):
        """Full-rate grayscale keyboard strips resampled to the roll rate:
        uint8 (rows, H, W), or None when nothing decodes. The strips come
        from ``strips_cache=[(uint8 (t, H, W) strips, duration)]``, else from
        full-rate frames in ``frames_cache``, else from decoding
        ``video_path`` (both of the latter need cv2)."""
        cond = self.cfg.conditioning
        strips = duration = None
        if strips_cache:
            strips, duration = strips_cache[0]
        if strips is None:
            frames = None
            if frames_cache:
                frames, duration, step = frames_cache[0]
                if step != 1:        # the tower decoded strided: strips need
                    frames = None    # the full frame rate, decode afresh
            if frames is None and video_path is not None:
                frames, duration = video_io.read_video_frames(video_path)
                if frames_cache is not None and not frames_cache:
                    frames_cache.append((frames, duration, 1))
            if frames is None:
                return None
            strips = video_io.piano_preprocess(frames, cond.piano_frame_w,
                                               cond.piano_frame_h)
        idx = video_io.interp_indices_piano(
            len(strips), duration, length, video_multi=self.cfg.model.video_multi,
            sample_rate=cond.sampling_rate, frame_size=cond.frame_size)
        return strips[idx]

    def _decode_strips(self, video_path: Optional[str], frames_cache: list,
                       strips_cache, strip_step: int):
        """(uint8 strips of every ``strip_step``-th source frame, duration,
        full-rate frame count). From ``strips_cache`` (full-rate strips,
        taken at ``strip_step`` as the fused decoder would give them), else
        by one decode of ``video_path`` that also puts RGB frames at the
        frame stride into an empty ``frames_cache``. Raises if neither
        gives strips: the pipeline never serves a zero roll."""
        if strips_cache:
            strips, duration = strips_cache[0]
            return strips[::strip_step], duration, len(strips)
        cond = self.cfg.conditioning
        rgb, strips, duration, n_src = video_io.read_video_frames_and_strips(
            video_path, step=self.frame_stride, width=cond.piano_frame_w,
            height=cond.piano_frame_h, strip_step=strip_step)
        if strips is None:
            raise RuntimeError(f"piano=True: no keyboard strips decoded from "
                               f"{video_path!r} (decoding needs cv2; pass "
                               f"strips_cache=[(strips, duration)] instead)")
        if not frames_cache:
            frames_cache.append((rgb, duration, self.frame_stride))
        return strips, duration, n_src

    def _ship_strips(self, strips: np.ndarray) -> torch.Tensor:
        """uint8 strips (t, H, W) -> a (1, t, H, W) uint8 batch on the
        device (the division by 255 happens there)."""
        return self._to_device(strips[None])

    def _strided_strip_plan(self, strips_src: np.ndarray, n_src: int,
                            duration: float, length: int):
        """``strip_stride``-strided strips on the device and their blend plan
        (strips, i0, i1, w), the tuple ``_roll_from_strips`` takes."""
        cond = self.cfg.conditioning
        i0, i1, w = video_io.interp_weights_piano(
            n_src, duration, length, self.strip_stride,
            video_multi=self.cfg.model.video_multi,
            sample_rate=cond.sampling_rate, frame_size=cond.frame_size)
        return (self._ship_strips(strips_src), self._to_device(i0).long(),
                self._to_device(i1).long(), self._to_device(w))

    @torch.inference_mode()
    def _roll_from_strips(self, strips_dev, n: int) -> torch.Tensor:
        """Video2Roll probabilities (1, n, notes) f32 from uploaded strips:
        a strided plan tuple, blended (s[i0]*(1-w) + s[i1]*w)/255 in f32, or
        strips already at the roll rate, /255."""
        if isinstance(strips_dev, tuple):
            strips, i0, i1, w = strips_dev
            s = strips.float()
            wb = w[None, :, None, None]
            frames = (s[:, i0] * (1.0 - wb) + s[:, i1] * wb) / 255.0
        else:
            frames = strips_dev.float() / 255.0
        return self.cfm.encode_frames(frames, n)

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
        strips_cache: Optional[list] = None,
    ) -> Tuple[np.ndarray, int]:
        """Silent video (+ optional prompt) -> generated waveform @ 24 kHz.

        The video arrives as a path, or already decoded as
        ``frames_cache=[(uint8 (t, H, W, 3) frames, duration_s, step)]``
        (step 1, or the frame stride). An empty prompt becomes a zero
        context of length 1 (the reference's dropped prompt); any other
        goes through T5. ``piano=True`` feeds keyboard strips through
        Video2Roll: strips decoded from ``video_path`` with cv2, or handed in
        as ``strips_cache=[(uint8 (t, 100, 900) full-rate strips,
        duration_s)]``; without either it raises. With ``duration_s`` left
        to the clip, strips are taken every ``strip_stride``-th and blended;
        an explicit ``duration_s`` takes every strip, as in JAX.
        ``fewstep=N`` runs N uniform Euler steps without CFG (the
        distilled-student mode). ``x0`` is drawn from a ``torch.Generator``
        seeded with ``seed``.
        """
        if passes > 1:
            raise NotImplementedError("passes > 1 (sample_multipass) is not "
                                      "ported yet")
        if piano and not strips_cache and video_path is None:
            raise ValueError("piano=True needs keyboard strips: a video path "
                             "to decode or strips_cache=[(strips, duration)]")
        dev = self.device
        cond = self.cfg.conditioning
        sr = cond.sampling_rate
        frames_cache = [] if frames_cache is None else frames_cache
        timings = {}
        t0 = time.perf_counter()

        def plan_length(dur_s):
            """(duration_s, n_valid, n) under the abs-pos ceiling."""
            max_n = ((self.cfg.model.max_seq_len
                      - self.cfg.model.num_registers) // 96) * 96
            nv = min(int(round(dur_s * sr / cond.frame_size)), max_n)
            return (min(dur_s, nv * cond.frame_size / sr), nv,
                    min(bucket_length(nv), max_n))

        n = strips_dev = None
        if piano and duration_s is None:
            # the strips decode with the frames; their duration plans n
            ss = self.strip_stride
            strips, dur, n_src = self._decode_strips(video_path, frames_cache,
                                                     strips_cache, ss)
            duration_s, n_valid, n = plan_length(min(dur or 10.0,
                                                     max_duration_s))
            if ss > 1:
                strips_dev = self._strided_strip_plan(strips, n_src, dur, n)
            else:
                strips_dev = self._ship_strips(self.encode_piano_frames(
                    video_path, n, strips_cache=[(strips, dur)]))
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
        elif n is None:
            duration_s, n_valid, n = plan_length(duration_s)

        b = 1
        tdim = self.cfg.model.dim_text_raw or self.cfg.model.dim_text
        text = torch.zeros(b, n, tdim, device=dev)
        if text_embed is not None:
            m = min(n, len(text_embed))
            text[0, :m] = text_embed[:m]
        if prompt.strip():
            t1 = time.perf_counter()
            ctx, ctx_mask = self.encode_text([prompt])
            self._sync()
            timings["text_encode_s"] = time.perf_counter() - t1
        else:
            # empty prompt: the T5 k/v projections carry no bias, so a zero
            # context of length 1 equals the zeroed encoder output
            ctx = torch.zeros(b, 1, self.cfg.model.dim_context, device=dev)
            ctx_mask = torch.ones(b, 1, dtype=torch.bool, device=dev)
        if piano:
            t1 = time.perf_counter()
            if strips_dev is None:      # explicit duration: every strip
                strips = self.encode_piano_frames(
                    video_path, n, frames_cache=frames_cache,
                    strips_cache=strips_cache)
                if strips is None:
                    raise RuntimeError(f"piano=True: no keyboard strips from "
                                       f"{video_path!r}")
                strips_dev = self._ship_strips(strips)
            frames_roll = self._roll_from_strips(strips_dev, n)
            self._sync()
            timings["roll_s"] = time.perf_counter() - t1
        else:
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
        self.last_roll = frames_roll[0] if piano else None
        return wav[0, : int(duration_s * sr)], sr
