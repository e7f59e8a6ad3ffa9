"""Training batch assembly: multi-corpus sampling, theta-ratio resampling,
mix augmentation, per-host striding, bad-sample blacklisting, fixed shapes.

A copy of ``v2ap_tpu/data/dataset.py``, which draws from one
``np.random.default_rng`` in the same order, so that both batchers give the
same batches from the same seed and files:
  * draw ``batch * oversample_multi`` candidates, resampled between the
    sound-effect and the other corpora toward ``theta_ratio``;
  * load and normalise 10 s 24 kHz windows (max-energy selection);
  * A-weighted mix augmentation with caption concatenation;
  * video / piano rows at the tail (every ``num_hosts``-th video sample
    from ``host_id``), their audio from the sibling ``<stem>.wav``;
  * 50 % of the video rows flagged ``video_drop_prompt``;
  * failed decodes go to a blacklist and the draw retries;
  * ``dpo=True``: each grad-accumulation micro-slice ends with a (winner,
    loser) preference pair (the batch layout only: the DPO loss is not
    ported).

Waveforms travel to the device; EnCodec latents are computed there
(``TrainingPipeline.device_batch``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from v2ap_torch.config import DataConfig
from v2ap_torch.data.audio_io import HOP_SIZE, load_training_clip
from v2ap_torch.data.manifests import Sample
from v2ap_torch.data.mixing import mix_captions, mix_waveforms


VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm")


@dataclasses.dataclass
class Batch:
    """Host-side batch; arrays fixed-shape, ready for the device."""
    waveforms: np.ndarray            # (b, n_samples) float32 @ 24 kHz
    lens: np.ndarray                 # (b,) latent-frame lengths
    captions: List[str]
    video_paths: List[Optional[str]]
    piano: List[bool]
    video_drop_prompt: np.ndarray    # (b,) bool — 50% flip for video rows
    audio_drop_prompt: np.ndarray    # (b,) bool
    # True when each grad-accum micro-slice ends with a (winner, loser)
    # preference pair (rows [-2]/[-1] of the slice — the layout the DPO
    # train step indexes)
    has_pairs: bool = False


class TrainBatcher:
    """``dpo=True`` emits batches where every grad-accum micro-slice
    (``batch_size // micro_batches`` rows) ends with a (winner, loser)
    preference pair drawn from ``Sample.pair_path`` manifests (rows
    [-2] / [-1] of each micro-batch)."""

    def __init__(self, samples: Sequence[Sample], cfg: DataConfig | None = None,
                 *, batch_size: int = 8, host_id: int = 0, num_hosts: int = 1,
                 mix_prob: float = 0.5, seed: int | None = None,
                 dpo: bool = False, micro_batches: int = 1):
        cfg = cfg or DataConfig()
        self.cfg = cfg
        self.batch_size = batch_size
        self.rng = np.random.default_rng(cfg.seed if seed is None else seed)
        self.blacklist: set = set()

        audio = [s for s in samples if not s.is_video and not s.pair_path]
        video = [s for s in samples if s.is_video and not s.pair_path]
        # per-host striding of the video corpora
        self.video_samples = video[host_id::num_hosts] if video else []
        self.audio_se = [s for s in audio if s.is_sound_effect]
        self.audio_non_se = [s for s in audio if not s.is_sound_effect]
        self.mix_prob = mix_prob

        self.dpo = dpo
        self.micro_batches = max(1, micro_batches)
        pairs = [s for s in samples if s.pair_path]
        self.pair_samples = pairs[host_id::num_hosts] if pairs else []
        if dpo:
            if not self.pair_samples:
                raise ValueError(
                    "dpo=True but no preference-pair samples: mark the pair "
                    "corpus with CorpusSpec(preference_pairs=True) and name "
                    "files a<id>/b<id> in the same directory")
            if batch_size % self.micro_batches != 0:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by micro_batches "
                    f"{self.micro_batches}")
            if batch_size // self.micro_batches < 2:
                raise ValueError("need >= 2 rows per micro-batch for a pair")

    # ------------------------------------------------------------- sampling
    def _draw_candidates(self, n: int) -> List[Sample]:
        """theta-ratio resampling between SE / non-SE corpora."""
        theta = self.cfg.theta_ratio
        out = []
        for _ in range(n):
            use_se = (self.rng.random() < theta) and self.audio_se
            pool = self.audio_se if use_se else (self.audio_non_se or self.audio_se)
            if not pool:
                break
            out.append(pool[int(self.rng.integers(len(pool)))])
        return out

    def _load(self, sample: Sample) -> Optional[np.ndarray]:
        if sample.path in self.blacklist:
            return None
        clip = load_training_clip(sample.path, self.cfg.target_length,
                                  rng=self.rng)
        if clip is None:
            self.blacklist.add(sample.path)
        return clip

    def _load_media_audio(self, path: str) -> Optional[np.ndarray]:
        """Audio for a media file: video containers read the sibling
        ``<stem>.wav`` (there is no mp4-audio decoder, so video and pair
        corpora ship transcoded sibling wavs)."""
        if path in self.blacklist:
            return None
        audio_path = path
        stem, ext = os.path.splitext(path)
        if ext.lower() in VIDEO_EXTS:
            audio_path = stem + ".wav"
        clip = load_training_clip(audio_path, self.cfg.target_length,
                                  rng=self.rng)
        if clip is None:
            self.blacklist.add(path)
        return clip

    def _draw_pair(self) -> Optional[tuple]:
        """((winner_row), (loser_row)) with loaded audio, or None when the
        pair pool is exhausted. Failed decodes blacklist the whole pair —
        a zero-audio side would make the preference signal meaningless."""
        for _ in range(16):
            if not self.pair_samples:
                return None
            s = self.pair_samples[int(self.rng.integers(len(self.pair_samples)))]
            if s.path in self.blacklist or s.pair_path in self.blacklist:
                continue
            w_wav = self._load_media_audio(s.path)
            l_wav = self._load_media_audio(s.pair_path)
            if w_wav is None or l_wav is None:
                self.blacklist.add(s.path)
                self.blacklist.add(s.pair_path)
                continue
            # a pair corpus may be marked is_video while holding plain wavs
            # (audio-only preference data); only real video containers become
            # conditioning paths
            is_vid = (s.is_video and
                      os.path.splitext(s.path)[1].lower() in VIDEO_EXTS)
            vp_w = s.path if is_vid else None
            vp_l = s.pair_path if is_vid else None
            return ((w_wav[0], s.caption, vp_w, s.is_piano),
                    (l_wav[0], s.caption, vp_l, s.is_piano))
        return None

    def _fill_rows(self, n: int) -> List[tuple]:
        """n ordinary rows: theta-resampled audio (+mix augmentation) with
        video/piano rows substituted at the tail."""
        cfg = self.cfg
        rows: List[tuple] = []          # (waveform, caption, video_path, piano)
        attempts = 0
        while len(rows) < n and attempts < 64:
            attempts += 1
            need = (n - len(rows)) * cfg.oversample_multi
            for sample in self._draw_candidates(need):
                wav = self._load(sample)
                if wav is None:
                    continue
                caption = sample.caption
                # A-weighted mix augmentation
                if (self.rng.random() < self.mix_prob
                        and (self.audio_se or self.audio_non_se)):
                    other = self._draw_candidates(1)
                    if other:
                        wav2 = self._load(other[0])
                        if wav2 is not None:
                            r = float(self.rng.uniform(0.25, 0.75))
                            wav = mix_waveforms(wav, wav2, r, cfg.sample_rate)
                            caption = mix_captions(caption, other[0].caption)
                rows.append((wav[0], caption, None, False))
                if len(rows) >= n:
                    break
            if not (self.audio_se or self.audio_non_se):
                break
        n_video = min(len(self.video_samples), max(0, n - len(rows))
                      ) or (1 if self.video_samples and rows else 0)
        video_rows: List[tuple] = []
        for _ in range(n_video):
            s = self.video_samples[int(self.rng.integers(len(self.video_samples)))]
            # training target audio for a video row comes from the sibling
            # wav when present; rows without one keep a zero waveform
            wav = self._load_media_audio(s.path)
            video_rows.append((wav[0] if wav is not None else None,
                               s.caption, s.path, s.is_piano))
        return rows[: n - len(video_rows)] + video_rows

    def next_batch(self) -> Batch:
        cfg = self.cfg
        target_samples = cfg.target_length * HOP_SIZE
        has_pairs = False
        if self.dpo:
            mb = self.batch_size // self.micro_batches
            rows = []
            for _ in range(self.micro_batches):
                pair = self._draw_pair()
                if pair is None:
                    raise RuntimeError(
                        "preference-pair pool exhausted (all pairs "
                        "blacklisted) — cannot assemble a DPO batch")
                filler = self._fill_rows(mb - 2)
                # exact micro-slice layout is load-bearing: pad a short fill
                # (tiny/exhausted audio pools) with extra pair rows so the
                # slice's last two rows stay the (winner, loser) pair
                while len(filler) < mb - 2:
                    extra = self._draw_pair()
                    if extra is None:
                        raise RuntimeError("preference-pair pool exhausted")
                    filler.extend(extra[: mb - 2 - len(filler)])
                rows.extend(filler)
                rows.extend(pair)
            has_pairs = True
        else:
            rows = self._fill_rows(self.batch_size)

        b = len(rows)
        waveforms = np.zeros((b, target_samples), np.float32)
        captions, video_paths, piano = [], [], []
        for i, (wav, cap, vp, pi) in enumerate(rows):
            if wav is not None:
                waveforms[i, : len(wav)] = wav[:target_samples]
            captions.append(cap)
            video_paths.append(vp)
            piano.append(pi)
        lens = np.full((b,), self.cfg.target_length, np.int32)
        is_video = np.asarray([vp is not None for vp in video_paths])
        return Batch(
            waveforms=waveforms, lens=lens, captions=captions,
            video_paths=video_paths, piano=piano,
            video_drop_prompt=is_video & (self.rng.random(b) < 0.5),
            audio_drop_prompt=np.zeros((b,), bool),
            has_pairs=has_pairs,
        )

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()
