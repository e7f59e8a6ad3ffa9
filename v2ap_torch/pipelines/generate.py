"""End-to-end generation pipeline: a silent video, and optionally a text
prompt, to audio (V2A) or piano music (V2P).

Counterpart of ``v2ap_tpu/pipelines/generate.py``:

  host:   video decode (cv2), or frames handed in through ``frames_cache``;
          for V2P also grayscale keyboard strips, decoded in the same pass
          or handed in through ``strips_cache``; the tagged on-disk frame,
          strip and roll caches beside the video (the JAX package's files)
  device: the video tower(s) of ``video_encoder`` over every
          ``frame_stride``-th frame, in chunks (uint8 frames resized to
          each tower's image size there, PIL-exact), blended linearly to
          the latent rate: CLIP ViT-bigG (``clip_vit``) [K2 kernel], CLIP
          ViT-L/14-336 (``clip_vit2``) [K2 kernel], ConvNeXt-XXLarge
          (``clip_convnext``), DINOv2-giant (``dinov2``), or all four
          concatenated per frame (``mixed``, 4608-d)
  device: FLAN-T5 over a non-empty prompt (plain PyTorch attention)
  device: Video2Roll over 5-strip windows, the strips blended from every
          ``strip_stride``-th one (V2P)
  device: 25-step sway-Euler CFM sampling, CFG batch-doubled, as one
          captured CUDA graph per shape and sampler (``_sample``,
          ``_sample_multipass``; restart passes for ``passes > 1``)
                                                                [K1 kernel]
  device: EnCodec decode

``generate`` serves one clip, ``generate_batch`` several at one bucketed
duration through one sampler call, ``generate_to_file`` writes the audio
(muxed onto the video when ffmpeg is installed).

The environment switches of the JAX pipeline that change its result are
read as it reads them: ``V2AP_FRAME_STRIDE`` and ``V2AP_STRIP_STRIDE``
override the config's strides (and tag the caches). ``quantize_towers=None``
means what it means in JAX: ``V2AP_INT8_TOWERS`` if set (``0`` is bf16),
else the int8 gate's persisted verdict, else int8 towers: every ``Linear``
of the video towers runs AQT's int8 product (``utils.quantize``; attention
stays bf16). ``quantize_cfm=None`` reads ``V2AP_INT8_CFM`` (``1``: every
``Linear`` of the CFM, Video2Roll's included, in int8). The modes tag the
feature and roll caches as JAX's do. What would change the result and is
not ported raises ``NotImplementedError`` rather than give another result:
a tokenizer (``tokenizer_path``, or ``V2AP_T5_TOKENIZER`` naming an
existing path: the sentencepiece / HF assets) and the wire-level shipping
modes (``V2AP_SHIP_YUV420=1``, ``V2AP_SHIP_STRIP_HALF=1``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from v2ap_torch.config import SamplerConfig, V2APConfig, fewstep_sampler
from v2ap_torch.data import video_io
from v2ap_torch.evaluation.int8_gate import read_gate_default
from v2ap_torch.models.cfm import CFM
from v2ap_torch.models.clip_vit import device_normalize
from v2ap_torch.models.encodec import EncodecConfig, EncodecModel
from v2ap_torch.models.t5 import T5Encoder, flan_t5_large
from v2ap_torch.models.video_towers import build_video_towers
from v2ap_torch.utils.device import resolve_device, seeded_init
from v2ap_torch.utils.jitting import (CapturedPrograms, batch_bucket,
                                      cast_params, pad_batch)
from v2ap_torch.utils.quantize import quantize_linears_int8


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


def _feature_tensor(feats: np.ndarray, device) -> torch.Tensor:
    """Cached features as a tensor on ``device``: float32 as the port
    writes them, or bf16 where the file holds the JAX package's bfloat16
    (numpy reads its two-byte values as void)."""
    if feats.dtype.kind == "V" and feats.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(feats).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(feats)).to(device)


def _env_stride(name: str, default: int) -> int:
    """A stride switch as the JAX pipeline reads it: the variable if set
    and non-empty, else the config's value, at least 1."""
    env = os.environ.get(name)
    return max(1, int(env) if env else default)


class V2APipeline:
    """Owns the model stack on one device (``device=None`` means CUDA).

    The frozen encoders (T5, the video towers) are stored in bf16 when the
    model computes in bf16, and nothing takes gradients. ``trainable_cfm``
    (which the JAX signature lacks; ``TrainingPipeline`` passes it) keeps
    the CFM's parameters float32 and trainable: the serving pipeline stores
    bf16 copies of the weights its bf16 layers cast (``cast_params``) and
    freezes every module, which training must not."""

    def __init__(self, cfg: V2APConfig | None = None, *, seed: int = 0,
                 device=None, tokenizer_path: Optional[str] = None,
                 t5_config=None, clip_config=None, encodec_config=None,
                 tower_configs: Optional[dict] = None,
                 quantize_towers: Optional[bool] = None,
                 quantize_cfm: Optional[bool] = None,
                 trainable_cfm: bool = False):
        env_tok = os.environ.get("V2AP_T5_TOKENIZER")
        if tokenizer_path is not None or (env_tok and os.path.exists(env_tok)):
            raise NotImplementedError(
                f"tokenizer {tokenizer_path or env_tok!r}: the sentencepiece / "
                "HF tokenizer assets are not supported yet; prompts go "
                "through FallbackTokenizer, the JAX package's tokenizer when "
                "no assets are present (unset V2AP_T5_TOKENIZER)")
        self.device = resolve_device(device)
        self.cfg = cfg = cfg or V2APConfig()
        cond = cfg.conditioning
        if quantize_towers is None:
            # the JAX pipeline's order: the variable, the gate file, int8
            env = os.environ.get("V2AP_INT8_TOWERS")
            if env is not None:
                quantize_towers = env != "0"
            else:
                gate = read_gate_default()
                quantize_towers = True if gate is None else gate
        if quantize_cfm is None:
            quantize_cfm = os.environ.get("V2AP_INT8_CFM", "0") == "1"
        for var in ("V2AP_SHIP_YUV420", "V2AP_SHIP_STRIP_HALF"):
            if os.environ.get(var) == "1":
                raise NotImplementedError(f"{var}=1: the wire-level shipping "
                                          f"modes are not ported yet")
        # encode every frame_stride-th frame and blend between them; keyboard
        # strips likewise at strip_stride (1 = the reference's every frame)
        self.frame_stride = _env_stride("V2AP_FRAME_STRIDE", cond.frame_stride)
        self.strip_stride = _env_stride("V2AP_STRIP_STRIDE", cond.strip_stride)
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
        # tower name -> config (tiny test configs); clip_config is the
        # shorthand for ViT-bigG's
        tower_configs = dict(tower_configs or {})
        if clip_config is not None:
            tower_configs.setdefault("clip_vit", clip_config)
        self.towers = build_video_towers(cond.video_encoder, seed=seed + 3,
                                         overrides=tower_configs,
                                         device=self.device)
        self.video_embed_dim = sum(t.embed_dim for t in self.towers)
        self.clip = self.towers[0].model
        self.clip_cfg = self.clip.cfg
        # frozen encoders are stored bf16 when the model computes in bf16;
        # the CFM keeps f32 parameters and stores bf16 copies of only the
        # weights its bf16 layers cast on every call (the same values)
        frozen = [self.codec, self.t5, *(t.model for t in self.towers)]
        if cfg.model.dtype == "bfloat16":
            for model in frozen[1:]:
                model.to(torch.bfloat16)
            if not trainable_cfm:
                cast_params(self.cfm, torch.bfloat16)
        for module in frozen + ([] if trainable_cfm else [self.cfm]):
            module.eval().requires_grad_(False)
        # int8 products on the stored weights (the caches' tags follow)
        self.quantize_cfm = bool(quantize_cfm)
        quantize_linears_int8(self.cfm, self.quantize_cfm)
        self.set_int8_towers(bool(quantize_towers))
        self.tokenize = FallbackTokenizer(self.t5_cfg.vocab_size)
        # the sampler's captured programs (CUDA only; the CPU runs eagerly)
        self.graphs = (CapturedPrograms() if self.device.type == "cuda"
                       else None)
        self.last_timings: dict = {}
        # seconds of each tower's part of the last encode_video_frames_clip
        self.tower_seconds: dict = {}
        self.last_roll: Optional[torch.Tensor] = None   # (n, notes), V2P

    # ------------------------------------------------------------------ io
    def load_weights(self, ckpt_dir: str) -> list:
        """Load what ``v2ap_torch.utils.checkpoint.save_model`` wrote under
        ``ckpt_dir``: the subdirectories ``cfm/``, ``encodec/``, ``t5/``,
        ``clip/`` and the video towers' names, whichever exist, else
        ``ckpt_dir`` itself as a bare CFM. Each tensor is copied into the
        pipeline's own in its dtype, so a float32 CFM state loads into the
        serving CFM's bf16-stored layers as ``cast_params`` rounds it.
        Returns the names loaded."""
        from v2ap_torch.utils.checkpoint import load_model

        pairs = [("cfm", self.cfm), ("encodec", self.codec), ("t5", self.t5),
                 ("clip", self.clip)]
        pairs += [(t.name, t.model) for t in self.towers]
        loaded, seen = [], set()
        for name, model in pairs:
            path = os.path.join(ckpt_dir, name)
            if os.path.isdir(path) and path not in seen:
                seen.add(path)
                load_model(path, model)
                loaded.append(name)
        if not loaded and os.path.isdir(ckpt_dir):
            load_model(ckpt_dir, self.cfm)       # a bare CFM directory
            loaded.append("cfm")
        return loaded

    def set_int8_towers(self, on: bool) -> int:
        """Run every ``Linear`` of the video towers in int8 (or back in
        bf16) in place; returns the number of layers set."""
        self.quantize_towers = on
        return sum(quantize_linears_int8(t.model, on) for t in self.towers)

    @property
    def _tower_tag(self) -> str:
        """The numerics tag of the frame-feature cache (JAX's): the towers'
        mode and the frame stride."""
        s = self.frame_stride
        return (("int8" if self.quantize_towers else "bf16")
                + (f"+s{s}" if s > 1 else ""))

    @property
    def _roll_tag(self) -> str:
        """The numerics tag of the roll cache (JAX's): the CFM's mode, whose
        Video2Roll computes the roll, and the strip stride."""
        ss = self.strip_stride
        return (("int8" if self.quantize_cfm else "bf16")
                + (f"+ss{ss}" if ss > 1 else ""))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _normal(self, seed: int, shape: tuple) -> torch.Tensor:
        """Standard normal float32 ``shape`` on the device from a
        ``torch.Generator`` seeded with ``seed`` (x0 from the call's seed,
        restart noise from seed + 1)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device)

    # --------------------------------------------------------------- sampler
    def _run_sampler(self, key: tuple, run, inputs: tuple,
                     warm_sampler: SamplerConfig,
                     batch_dims: Sequence[int]) -> torch.Tensor:
        """``run(*inputs)`` eagerly on the CPU; on CUDA as the captured
        program of ``key`` plus the inputs' shapes and dtypes, warmed up
        once with ``warm_sampler`` (a one-step trajectory: every operation
        of the program at its shapes). There the batch (``batch_dims``: each
        input's batch axis) is padded to ``batch_bucket`` rows by repeating
        the last, and the output cut back: rows do not mix, so the padding
        changes no row's maths."""
        if self.graphs is None:
            return run(*inputs)
        b = inputs[0].shape[0]
        size = batch_bucket(b)
        inputs = tuple(pad_batch(t, size, d)
                       for t, d in zip(inputs, batch_dims))
        key = key + tuple(None if t is None else (tuple(t.shape), t.dtype)
                          for t in inputs)
        out = self.graphs.run(key, run, inputs,
                              warmup=lambda *a: run(*a, sampler=warm_sampler))
        return out[:b]

    @torch.inference_mode()
    def _sample(self, x0, text, frames_roll, ctx, ctx_mask, mask,
                sampler: SamplerConfig) -> torch.Tensor:
        """``CFM.sample`` over (b, n) latents: one captured program per
        (batch bucket, shapes, dtypes, sampler), the counterpart of JAX's
        ``nnx.jit`` with the sampler static."""
        def run(x0, text, frames_roll, ctx, ctx_mask, mask, sampler=sampler):
            return self.cfm.sample(x0, text_embed=text,
                                   frames_embed=frames_roll, context=ctx,
                                   context_mask=ctx_mask, mask=mask,
                                   sampler=sampler)

        return self._run_sampler(
            ("sample", sampler), run,
            (x0, text, frames_roll, ctx, ctx_mask, mask),
            dataclasses.replace(sampler, steps=2), (0,) * 6)

    @torch.inference_mode()
    def _sample_multipass(self, x0, text, frames_roll, ctx, ctx_mask, mask,
                          sampler: SamplerConfig, noises: torch.Tensor,
                          passes: int, restart_t: float) -> torch.Tensor:
        """``CFM.sample_multipass`` with its restart noise handed in
        ((passes - 1, b, n, C), drawn before the program): one captured
        program per (shapes, dtypes, sampler, passes, restart_t)."""
        def run(x0, text, frames_roll, ctx, ctx_mask, mask, noises,
                sampler=sampler):
            return self.cfm.sample_multipass(
                x0, passes=passes, restart_t=restart_t, noises=noises,
                text_embed=text, frames_embed=frames_roll, context=ctx,
                context_mask=ctx_mask, mask=mask, sampler=sampler)

        return self._run_sampler(
            ("multipass", sampler, passes, restart_t), run,
            (x0, text, frames_roll, ctx, ctx_mask, mask, noises),
            dataclasses.replace(sampler, steps=2), (0,) * 6 + (1,))

    # ------------------------------------------------------------ conditioning
    @torch.no_grad()
    def _encode_audio(self, waveforms: torch.Tensor) -> torch.Tensor:
        """EnCodec latents of waveforms: (b, t) float32 at 24 kHz ->
        (b, t / 320, 128) float32 on the device (the training targets)."""
        return self.codec.encode(waveforms.to(self.device).float())

    @torch.inference_mode()
    def encode_text(self, prompts: Sequence[str]):
        """Prompts -> (T5 hidden states (b, 64, d_model) in T5's dtype, bool
        mask (b, 64)) on the device; padded rows are zero."""
        ids, mask = self.tokenize(list(prompts))
        mask = self._to_device(mask).bool()
        return self.t5(self._to_device(ids).long(), mask), mask

    def _tower_frames(self, video_path: Optional[str], frames_cache: list):
        """The frames the towers encode, every ``frame_stride``-th one, and
        the clip's duration. Decodes the video into ``frames_cache`` unless
        it already holds (frames, duration, step), with step 1 (full rate)
        or the frame stride."""
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
        return frames, duration

    @torch.inference_mode()
    def encode_video_frames_clip(self, video_path: Optional[str], length: int,
                                 chunk: Optional[int] = None,
                                 frames_cache=None):
        """Tower embeddings at the latent rate, zero-padded to ``length``
        rows: ((length, video_embed_dim) float32 on the device, duration).
        With ``feature_cache`` on and a video path, each tower's cache file
        beside the video (of this tag) answers for it, and the towers it
        does not answer write theirs. The others encode the frames of one
        ``frames_cache`` (decoded once), each 64-frame chunk uploaded once
        as uint8 and put through every tower's geometry and model on the
        device. In "mixed" mode the embeddings are cut to the shortest and
        concatenated per frame (1280 + 768 + 1024 + 1536 = 4608). At frame
        stride 1 each row takes its nearest frame; above 1 it blends the two
        nearest encoded frames in float32. ``tower_seconds`` gets each
        tower's seconds (its cache read, or its geometry and model)."""
        chunk = chunk or 64
        frames_cache = [] if frames_cache is None else frames_cache
        self.tower_seconds = {}
        feats, caches, duration = {}, {}, None
        if self.cfg.conditioning.feature_cache and video_path is not None:
            for tower in self.towers:
                t0 = time.perf_counter()
                caches[tower.name] = video_io.clip_feature_cache_path(
                    video_path, tower.name)
                got, d = video_io.load_feature_cache(caches[tower.name],
                                                     tag=self._tower_tag)
                if got is not None:
                    feats[tower.name] = _feature_tensor(got, self.device)
                    duration = d
                    self.tower_seconds[tower.name] = time.perf_counter() - t0
        todo = [t for t in self.towers if t.name not in feats]
        if todo:
            frames, duration = self._tower_frames(video_path, frames_cache)
            if frames is None:
                return None, None
            parts = {t.name: [] for t in todo}
            seconds = dict.fromkeys(parts, 0.0)
            for i in range(0, len(frames), chunk):
                px = self._to_device(frames[i: i + chunk])
                for tower in todo:
                    t0 = time.perf_counter()
                    parts[tower.name].append(tower.model(device_normalize(
                        tower.preprocess(px), tower.mean, tower.std)))
                    self._sync()
                    seconds[tower.name] += time.perf_counter() - t0
            for tower in todo:
                feats[tower.name] = torch.cat(parts[tower.name])
                if tower.name in caches:
                    # float32 holds a bf16 feature exactly, and both
                    # packages read it
                    video_io.save_feature_cache(
                        caches[tower.name],
                        feats[tower.name].float().cpu().numpy(), duration,
                        tag=self._tower_tag)
            self.tower_seconds.update(seconds)
        per_tower = [feats[t.name].float() for t in self.towers]
        t = min(len(f) for f in per_tower)
        feats = torch.cat([f[:t] for f in per_tower], dim=-1)
        cond = self.cfg.conditioning
        kw = dict(sample_rate=cond.sampling_rate, frame_size=cond.frame_size)
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
        from the strip cache beside the video (``feature_cache`` on), else
        ``strips_cache=[(uint8 (t, H, W) strips, duration)]``, else
        full-rate frames in ``frames_cache``, else decoding ``video_path``
        (both of the latter need cv2); strips that did not come from the
        cache are written to it."""
        cond = self.cfg.conditioning
        cache = (video_io.piano_frames_cache_path(video_path)
                 if cond.feature_cache and video_path is not None else None)
        strips, duration = (video_io.load_feature_cache(cache)
                            if cache is not None else (None, None))
        if strips is None and strips_cache:
            strips, duration = strips_cache[0]
            if strips is not None and cache is not None:
                video_io.save_feature_cache(cache, strips, duration)
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
            if cache is not None:
                video_io.save_feature_cache(cache, strips, duration)
        if strips.ndim == 4:                  # caches store (t, h, w, 1)
            strips = strips[..., 0]
        if strips.dtype != np.uint8:          # older float caches
            strips = np.clip(strips * 255.0, 0, 255).round().astype(np.uint8)
        idx = video_io.interp_indices_piano(
            len(strips), duration, length, video_multi=self.cfg.model.video_multi,
            sample_rate=cond.sampling_rate, frame_size=cond.frame_size)
        return strips[idx]

    def _decode_strips(self, video_path: Optional[str], frames_cache: list,
                       strips_cache):
        """(uint8 strips of every ``strip_stride``-th source frame, duration,
        full-rate frame count), or None when nothing gives strips. From
        ``strips_cache`` (full-rate strips, taken at the stride as the fused
        decoder would give them), else by one decode of ``video_path`` that
        also puts RGB frames at the frame stride into an empty
        ``frames_cache``."""
        ss = self.strip_stride
        if strips_cache:
            strips, duration = strips_cache[0]
            return strips[::ss], duration, len(strips)
        if video_path is None:
            return None
        cond = self.cfg.conditioning
        rgb, strips, duration, n_src = video_io.read_video_frames_and_strips(
            video_path, step=self.frame_stride, width=cond.piano_frame_w,
            height=cond.piano_frame_h, strip_step=ss)
        if strips is None:
            return None
        if not frames_cache:
            frames_cache.append((rgb, duration, self.frame_stride))
        return strips, duration, n_src

    def _piano_strips(self, video_path: Optional[str], length: int,
                      frames_cache: list, strips_cache, source=None):
        """Keyboard strips for a roll of ``length`` rows, on the device, as
        ``_roll_from_strips`` takes them, or None when nothing gives strips.
        With ``source`` (``_decode_strips``'s result) at a strip stride above
        1, the strided blend plan; otherwise the rows ``encode_piano_frames``
        gives from the source's full-rate strips, the strip cache,
        ``strips_cache``, ``frames_cache`` or a decode."""
        if source is not None:
            strips, dur, n_src = source
            if self.strip_stride > 1:
                return self._strided_strip_plan(strips, n_src, dur, length)
            strips_cache = [(strips, dur)]
        rows = self.encode_piano_frames(video_path, length,
                                        frames_cache=frames_cache,
                                        strips_cache=strips_cache)
        return None if rows is None else self._ship_strips(rows)

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
    def _plan_length(self, dur_s: float) -> Tuple[float, int, int]:
        """(duration_s, n_valid, n): valid latents and their 96-bucket under
        the abs-pos ceiling (latents + registers fit max_seq_len)."""
        cond = self.cfg.conditioning
        sr = cond.sampling_rate
        max_n = ((self.cfg.model.max_seq_len
                  - self.cfg.model.num_registers) // 96) * 96
        nv = min(int(round(dur_s * sr / cond.frame_size)), max_n)
        return (min(dur_s, nv * cond.frame_size / sr), nv,
                min(bucket_length(nv), max_n))

    def _sampler(self, steps: int, cfg_strength: float,
                 fewstep: Optional[int]) -> SamplerConfig:
        """The 25-step sway CFG sampler, or ``fewstep`` uniform Euler steps
        without CFG (the distilled-student mode)."""
        if fewstep:
            return fewstep_sampler(fewstep)
        return SamplerConfig(steps=steps, cfg_strength=cfg_strength,
                             sway_sampling=True)

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
        restart_t: float = 0.6,
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
        Video2Roll: strips decoded from ``video_path`` with cv2, read from
        the roll or strip cache beside it, or handed in as
        ``strips_cache=[(uint8 (t, 100, 900) full-rate strips,
        duration_s)]``; without any it raises. With ``duration_s`` left to
        the clip, strips are taken every ``strip_stride``-th and blended; an
        explicit ``duration_s`` takes every strip, as in JAX.
        ``fewstep=N`` runs N uniform Euler steps without CFG (the
        distilled-student mode). ``passes > 1`` refines by restart sampling
        from ``restart_t``. x0 is drawn from a ``torch.Generator`` seeded
        with ``seed``, the restart noise from one seeded with ``seed + 1``.
        """
        if piano and not strips_cache and video_path is None:
            raise ValueError("piano=True needs keyboard strips: a video path "
                             "to decode or strips_cache=[(strips, duration)]")
        dev = self.device
        cond = self.cfg.conditioning
        sr = cond.sampling_rate
        caching = cond.feature_cache and video_path is not None
        frames_cache = [] if frames_cache is None else frames_cache
        timings = {}
        t0 = time.perf_counter()

        n = strips_dev = roll_np = None
        if piano and duration_s is None:
            if caching:
                # the roll cache skips the strips and Video2Roll altogether
                roll_np, roll_dur = video_io.load_feature_cache(
                    video_io.piano_roll_cache_path(video_path),
                    tag=self._roll_tag)
                if roll_np is not None:
                    duration_s, n_valid, n = self._plan_length(
                        min(roll_dur, max_duration_s))
                    if len(roll_np) != n:         # another length bucket
                        roll_np = duration_s = n = None
            # strided strips never read the full-rate strip cache: its exact
            # rolls would land under the strided roll tag
            has_strip_cache = (self.strip_stride == 1 and caching
                               and os.path.exists(
                                   video_io.piano_frames_cache_path(video_path)))
            if roll_np is None and not has_strip_cache:
                # the strips decode with the frames; their duration plans n
                source = self._decode_strips(video_path, frames_cache,
                                             strips_cache)
                if source is None:
                    raise RuntimeError(
                        f"piano=True: no keyboard strips decoded from "
                        f"{video_path!r} (decoding needs cv2; pass "
                        f"strips_cache=[(strips, duration)] instead)")
                duration_s, n_valid, n = self._plan_length(
                    min(source[1] or 10.0, max_duration_s))
                strips_dev = self._piano_strips(video_path, n, frames_cache,
                                                strips_cache, source)
        text_embed, video_duration = None, None
        if video_path is not None or frames_cache:
            probe_len = int(max_duration_s * sr / cond.frame_size)
            text_embed, video_duration = self.encode_video_frames_clip(
                video_path, probe_len, frames_cache=frames_cache)
        self._sync()
        timings["video_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if duration_s is None:
            duration_s, n_valid, n = self._plan_length(
                min(video_duration or 10.0, max_duration_s))
        elif n is None:
            duration_s, n_valid, n = self._plan_length(duration_s)

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
        roll_cache_write = None
        if piano:
            t1 = time.perf_counter()
            if roll_np is not None:                       # roll-cache hit
                frames_roll = self._to_device(roll_np[None]).float()
            else:
                if strips_dev is None:  # explicit duration or the strip cache
                    strips_dev = self._piano_strips(video_path, n,
                                                    frames_cache, strips_cache)
                    if strips_dev is None:
                        raise RuntimeError(f"piano=True: no keyboard strips "
                                           f"from {video_path!r}")
                frames_roll = self._roll_from_strips(strips_dev, n)
                if caching:
                    # tagged by the path that made the roll: the exact path
                    # can run at strip stride > 1 (explicit duration_s)
                    tag = self._roll_tag
                    if not isinstance(strips_dev, tuple):
                        tag = tag.split("+ss")[0]
                    roll_cache_write = (video_io.piano_roll_cache_path(
                        video_path), duration_s, tag)
            self._sync()
            timings["roll_s"] = time.perf_counter() - t1
        else:
            frames_roll = torch.zeros(b, n, self.cfg.model.notes, device=dev)
        mask = torch.arange(n, device=dev)[None, :] < n_valid
        x0 = self._normal(seed, (b, n, self.cfg.model.num_channels))
        timings["conditioning_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sampler = self._sampler(steps, cfg_strength, fewstep)
        if passes > 1:
            noises = self._normal(seed + 1, (passes - 1,) + tuple(x0.shape))
            latents = self._sample_multipass(x0, text, frames_roll, ctx,
                                             ctx_mask, mask, sampler, noises,
                                             passes, restart_t)
        else:
            latents = self._sample(x0, text, frames_roll, ctx, ctx_mask,
                                   mask, sampler)
        self._sync()
        timings["sample_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wav = self.codec.decode(latents[:, :n_valid]).cpu().numpy()
        timings["decode_s"] = time.perf_counter() - t0
        if roll_cache_write is not None:
            path, dur, tag = roll_cache_write
            video_io.save_feature_cache(path, frames_roll[0].cpu().numpy(),
                                        dur, tag=tag)
        self.last_timings = timings
        self.last_roll = frames_roll[0] if piano else None
        return wav[0, : int(duration_s * sr)], sr

    @torch.inference_mode()
    def generate_batch(
        self,
        video_paths: Sequence[Optional[str]],
        prompts: Sequence[str],
        *,
        duration_s: float = 10.0,
        steps: int = 25,
        cfg_strength: float = 2.0,
        piano: bool = False,
        seed: int = 0,
        fewstep: Optional[int] = None,
        frames_caches: Optional[Sequence[Optional[list]]] = None,
        strips_caches: Optional[Sequence[Optional[list]]] = None,
        x0=None,
    ) -> Tuple[np.ndarray, int]:
        """Throughput mode: b clips ride the batch axis of ONE sampler call
        at one bucketed duration. Returns ((b, samples) float32, 24000).

        Clip i comes from ``video_paths[i]``, or decoded through
        ``frames_caches[i]`` / ``strips_caches[i]`` (each as ``generate``'s
        ``frames_cache`` / ``strips_cache``). A clip with no video, or one
        that does not decode, gets zero features (and a zero roll), as in
        JAX. Empty prompts get a zero context; if every prompt is empty T5
        does not run. x0 is drawn from ``seed`` unless ``x0`` ((b, n, C)
        float32) is given."""
        dev = self.device
        cond = self.cfg.conditioning
        mcfg = self.cfg.model
        sr = cond.sampling_rate
        b = len(video_paths)
        frames_caches = list(frames_caches or [None] * b)
        strips_caches = list(strips_caches or [None] * b)
        if not len(prompts) == len(frames_caches) == len(strips_caches) == b:
            raise ValueError("video_paths, prompts, frames_caches and "
                             "strips_caches need one entry per clip")
        _, n_valid, n = self._plan_length(duration_s)
        t0 = time.perf_counter()
        tdim = mcfg.dim_text_raw or mcfg.dim_text
        text = torch.zeros(b, n, tdim, device=dev)
        frames_roll = torch.zeros(b, n, mcfg.notes, device=dev)
        for i, vp in enumerate(video_paths):
            decoded = list(frames_caches[i] or [])
            if vp is None and not decoded and not strips_caches[i]:
                continue
            if piano:
                # the strips decode first, with the frames the tower takes
                strips_dev = self._piano_strips(
                    vp, n_valid, decoded, strips_caches[i],
                    self._decode_strips(vp, decoded, strips_caches[i]))
                if strips_dev is not None:
                    frames_roll[i] = self._roll_from_strips(strips_dev, n)[0]
            if vp is not None or decoded:
                feats, _ = self.encode_video_frames_clip(
                    vp, n_valid, frames_cache=decoded)
                if feats is not None:
                    text[i, : len(feats)] = feats[:n]
        if all(not p.strip() for p in prompts):
            # every prompt dropped: a zero context of any length equals the
            # zeroed T5 output (bias-free k/v), so T5 does not run
            ctx = torch.zeros(b, 1, mcfg.dim_context, device=dev)
            ctx_mask = torch.ones(b, 1, dtype=torch.bool, device=dev)
        else:
            eff = [p if p.strip() else "the sound of X X" for p in prompts]
            drop = torch.tensor([not p.strip() for p in prompts], device=dev)
            ctx, ctx_mask = self.encode_text(eff)
            ctx = torch.where(drop[:, None, None], 0.0, ctx)
        mask = (torch.arange(n, device=dev)[None, :] < n_valid).repeat(b, 1)
        x0 = (self._normal(seed, (b, n, mcfg.num_channels)) if x0 is None
              else torch.as_tensor(x0, dtype=torch.float32, device=dev))
        self._sync()
        timings = {"conditioning_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        latents = self._sample(x0, text, frames_roll, ctx, ctx_mask, mask,
                               self._sampler(steps, cfg_strength, fewstep))
        self._sync()
        timings["sample_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wavs = self.codec.decode(latents[:, :n_valid]).cpu().numpy()
        timings["decode_s"] = time.perf_counter() - t0
        self.last_timings = timings
        return wavs[:, : int(duration_s * sr)], sr

    def generate_to_file(self, video_path: str, out_path: str, **kw) -> str:
        """``generate`` the video's audio and put it onto the video at
        ``out_path`` with ffmpeg; without ffmpeg the audio is written to
        ``<out_path stem>.wav`` only. Returns ``out_path``."""
        wav, sr = self.generate(video_path, **kw)
        video_io.mux_audio_onto_video(video_path, wav, sr, out_path)
        return out_path
