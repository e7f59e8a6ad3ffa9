"""End-to-end training: corpora -> batches -> device encoders -> train step
-> eval and checkpoints.

Counterpart of ``v2ap_tpu/training/pipeline.py``. With ``mesh``
(``parallel.make_mesh``) the CFM is sharded by the tensor-parallel rules
and the trainer steps on the mesh (``Trainer(mesh=)``): each rank encodes
its own batcher's batch (``TrainBatcher(host_id=, num_hosts=)`` over the
data axis; the ranks of one model group share theirs), which is its
rows of the global batch, and metrics are averaged over the ranks
(``all_hosts_mean``):

  host:   TrainBatcher (manifests, mixing, blacklists, 50 % video-prompt
          flip)
  device: EnCodec encode (waveform -> latents), T5 contexts, the video
          tower features of ``video_encoder`` (each tower's from its
          feature cache beside each video, else the frames through the
          tower; "mixed" concatenates the four), keyboard strips (from the strip cache, else
          the video) and the ``<stem>.3.npy`` ground-truth roll for piano
          rows, the CFM train step (K3, K4, K5 on the card)
  loop:   resume, heartbeat, metrics, switch-EMA, exact-state checkpoints,
          periodic eval with latent figures

A machine without cv2 (the card's) cannot decode videos: it trains from
the feature and strip caches, which ``encode_video_frames_clip(...,
frames_cache=...)`` and ``encode_piano_frames(..., strips_cache=...)`` of
the pipeline write from decoded frames and strips; a video row without
them gets zero features and no frames, as in JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from v2ap_torch.config import V2APConfig
from v2ap_torch.parallel.distributed import all_hosts_mean, host_shard_info
from v2ap_torch.pipelines.generate import V2APipeline
from v2ap_torch.training.resilience import AutoResumer, Watchdog
from v2ap_torch.training.trainer import Trainer
from v2ap_torch.utils.observability import MetricsLogger


class TrainingPipeline:
    """The CFM of a ``V2APipeline`` built with ``trainable_cfm=True`` (float32
    parameters that take gradients; Video2Roll inside it trains through the
    MIDI loss), its frozen encoders (bf16 towers, never int8), a ``Trainer``
    with ``cfg.train``, checkpoints under ``work_dir/ckpts``, the heartbeat
    ``work_dir/heartbeat.json`` and metrics under ``work_dir/logs``.
    ``device=None`` means CUDA. ``mesh`` shards the CFM and the step over
    the mesh's ranks (module docstring); only rank 0 writes the heartbeat,
    the metrics and (gathered) checkpoints."""

    def __init__(self, cfg: V2APConfig | None = None, *, seed: int = 0,
                 work_dir: str = "runs/v2ap", t5_config=None,
                 clip_config=None, encodec_config=None, device=None,
                 mesh=None):
        self.cfg = cfg or V2APConfig()
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.pipe = V2APipeline(self.cfg, seed=seed, device=device,
                                t5_config=t5_config, clip_config=clip_config,
                                encodec_config=encodec_config,
                                quantize_towers=False, trainable_cfm=True)
        self.device = self.pipe.device
        self.mesh = mesh
        self.trainer = Trainer(self.pipe.cfm, self.cfg.train, seed=seed,
                               mesh=mesh)
        self.resumer = AutoResumer(self.trainer,
                                   os.path.join(work_dir, "ckpts"),
                                   save_every=self.cfg.train.save_step)
        self.watchdog = Watchdog(os.path.join(work_dir, "heartbeat.json"))
        self.metrics = MetricsLogger(os.path.join(work_dir, "logs"))

    # ------------------------------------------------------------- encoding
    def device_batch(self, batch) -> dict:
        """Host ``Batch`` -> the train step's dict on the device: latents,
        lens, text_embed (CLIP features at the latent rate, zero for audio
        rows), context and context_mask (T5; "the sound of X X" and a zero
        context on ``video_drop_prompt`` rows), midis, and frames (strips
        in [0, 1]) when a piano row has strips."""
        mc = self.cfg.model
        dev = self.device
        pipe = self.pipe
        latents = pipe._encode_audio(torch.from_numpy(batch.waveforms))
        b, n, _ = latents.shape
        text = torch.zeros(b, n, mc.dim_text_raw or mc.dim_text, device=dev)
        frames = None
        midis = torch.zeros(b, n, mc.notes, device=dev)
        for i, vp in enumerate(batch.video_paths):
            if vp is None:
                continue
            # video_drop_prompt swaps only the prompt (below); the CLIP
            # stream stays on, to train video-only conditioning
            feats, _ = pipe.encode_video_frames_clip(vp, n)
            if feats is not None:
                text[i, : len(feats)] = feats[:n]
            if batch.piano[i]:
                strips = pipe.encode_piano_frames(vp, n)
                if strips is not None:
                    rows = int(np.floor(n / mc.video_multi)) + 1
                    if frames is None:
                        frames = torch.zeros((b, rows) + strips.shape[1:],
                                             device=dev)
                    s = torch.from_numpy(strips[:rows]).to(dev)
                    frames[i, : len(s)] = s.float() / 255.0
                gt_path = vp.replace(".mp4", ".3.npy")
                if os.path.exists(gt_path):
                    gt = np.load(gt_path).astype(np.float32)[
                        :, mc.note_min: mc.note_max + 1]
                    midis[i, : len(gt)] = torch.from_numpy(gt[:n]).to(dev)

        prompts = ["the sound of X X" if batch.video_drop_prompt[i]
                   else (c or "") for i, c in enumerate(batch.captions)]
        ctx, ctx_mask = pipe.encode_text(prompts)
        drop = torch.from_numpy(np.asarray(batch.video_drop_prompt)).to(dev)
        out = {
            "latents": latents,
            "lens": torch.from_numpy(np.asarray(batch.lens)).to(dev),
            "text_embed": text,
            # out of inference mode: autograd saves these
            "context": torch.where(drop[:, None, None], 0.0, ctx),
            "context_mask": ctx_mask.clone(),
            "midis": midis,
        }
        if frames is not None:
            out["frames"] = frames
        return out

    # ----------------------------------------------------------------- loop
    def fit(self, batcher, *, num_steps: int, eval_batcher=None,
            log_every: int = 20, seed: int = 0) -> int:
        """Train until step ``num_steps``, resuming from the latest
        checkpoint; the loss's draws come from the trainer's generator
        seeded ``seed + start`` (JAX's ``key(seed + start)``). Every
        ``log_every`` steps and at the last: metrics (with ``dpo`` and
        ``contrastive`` when they are on) and a heartbeat (JAX's skips the
        last unless ``log_every`` divides it); every
        ``switch_ema_every``: switch-EMA; every ``save_step``: a checkpoint
        and, with ``eval_batcher``, the val loss / F1 and target / pred
        latent figures. Returns the final step."""
        start = self.resumer.maybe_resume()
        self.trainer.generator.manual_seed(seed + start)
        it = iter(batcher)
        eval_it = iter(eval_batcher) if eval_batcher is not None else None
        for _ in range(start, num_steps):
            loss, breakdown = self.trainer.train_step(
                self.device_batch(next(it)))
            step = self.trainer.step
            if step % log_every == 0 or step == num_steps:
                scalars = dict(loss=float(loss), flow=float(breakdown.flow),
                               midi=float(breakdown.midi))
                if self.cfg.train.dpo:
                    scalars["dpo"] = float(breakdown.dpo)
                if self.cfg.train.contrastive:
                    scalars["contrastive"] = float(breakdown.contrastive)
                scalars = {k: all_hosts_mean(v) for k, v in scalars.items()}
                if host_shard_info()[0] == 0:
                    self.metrics.log(step, **scalars)
                    self.watchdog.beat(step, loss=scalars["loss"])
            se = self.cfg.train.switch_ema_every
            if se and step % se == 0 and self.trainer.ema is not None:
                self.trainer.switch_ema()
            if self.resumer.maybe_save() and eval_it is not None:
                eb = self.device_batch(next(eval_it))
                eloss, ebk, pred = self.trainer.eval_step(
                    eb, return_pred=True,
                    generator=torch.Generator(self.device).manual_seed(0))
                val = dict(val_loss=all_hosts_mean(float(eloss)),
                           val_f1=all_hosts_mean(float(ebk.f1)))
                if host_shard_info()[0] == 0:
                    self.metrics.log(step, **val)
                    self.metrics.log_spectrogram(step, "target",
                                                 eb["latents"][0])
                    self.metrics.log_spectrogram(step, "pred", pred[0])
        return self.trainer.step
