"""Reflow-distill a trained CFM into a few-step sampler.

    # on the card, from a CFM saved with save_model (e.g. a converted or
    # trained DIR/cfm), synthetic conditioning
    python -m v2ap_torch.distill --ckpt ckpts/v2ap/cfm --out ckpts/reflow \\
        --steps 2000

    # the CPU-runnable miniature
    python -m v2ap_torch.distill --ckpt none --out /tmp/reflow --tiny \\
        --device cpu --steps 2 --batch 2 --frames 48 --teacher-steps 2

Counterpart of ``scripts/distill_reflow.py``: the teacher (``load_model``
from ``--ckpt`` when that directory exists, else weights from seed 0)
draws (noise, sample) pairs with its guided sampler (``--teacher-steps``
sway steps, CFG ``--cfg-strength``); a student initialised from the
teacher's weights is fine-tuned on the coupled pairs
(``training.distill``) and written with ``save_model`` to ``--out``;
sample it with ``V2APipeline.generate(fewstep=2)``. Every draw is seeded
0, as in JAX's script. ``--tiny`` is ``tiny_tower_test()`` (JAX's script
takes ``tiny_test()``), whose tiny serving pipeline loads the student.
Conditioning is seeded gaussian CLIP features unless ``--scp`` names
videos, whose frames the pipeline decodes with cv2 (a machine without
cv2, as the card's, cannot use ``--scp``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.distill")
    ap.add_argument("--ckpt", required=True,
                    help="the teacher's save_model directory (weights "
                         "from seed 0 when it does not exist)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=736)
    ap.add_argument("--teacher-steps", type=int, default=25)
    ap.add_argument("--cfg-strength", type=float, default=2.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--scp", default=None,
                    help="video manifest for real CLIP conditioning (else "
                         "synthetic); the videos are decoded with cv2, which "
                         "the card's machine lacks")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature model (tiny_tower_test(), which the "
                         "port's tiny serving pipeline loads)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from v2ap_torch import config as cfglib
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.training.distill import (ReflowConfig, ReflowDistiller,
                                             make_pair_sampler)
    from v2ap_torch.utils.checkpoint import load_model, save_model
    from v2ap_torch.utils.device import resolve_device, seeded_init

    device = resolve_device(args.device)
    cfg = cfglib.tiny_tower_test() if args.tiny else cfglib.v2a_default()
    mc = cfg.model

    def build():
        with seeded_init(0, device):
            return CFM(mc, cfg.conditioning, device=device,
                       with_video2roll=mc.video2roll)

    teacher = build()
    if os.path.isdir(args.ckpt):
        load_model(args.ckpt, teacher)
        print(f"loaded teacher from {args.ckpt}")
    teacher.eval().requires_grad_(False)
    student = build()
    student.load_state_dict(teacher.state_dict())
    rcfg = ReflowConfig(learning_rate=args.lr, decay_steps=args.steps,
                        teacher_steps=args.teacher_steps,
                        cfg_strength=args.cfg_strength)
    pairs = make_pair_sampler(teacher, rcfg)
    distiller = ReflowDistiller(student, rcfg, seed=0)

    b, n = args.batch, args.frames
    pipe = videos = None
    if args.scp:
        from v2ap_torch.pipelines.generate import V2APipeline
        pipe = V2APipeline(cfg, device=device, quantize_towers=False)
        with open(args.scp) as f:
            videos = [ln.split("\t")[0] for ln in f if ln.strip()]
    rng = np.random.default_rng(0)
    x0_gen = torch.Generator(device=device).manual_seed(0)
    frames0 = torch.zeros(b, n, mc.notes, device=device)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    ctx = torch.zeros(b, 1, mc.dim_context, device=device)
    ctx_mask = torch.ones(b, 1, dtype=torch.bool, device=device)
    lens = torch.full((b,), n, device=device)
    for step in range(args.steps):
        if pipe is not None:
            text = torch.zeros(b, n, mc.dim_text, device=device)
            for i in range(b):
                feats, _ = pipe.encode_video_frames_clip(
                    videos[(step * b + i) % len(videos)], n)
                if feats is not None:
                    text[i, : len(feats)] = feats[:n].float()
        else:
            text = torch.from_numpy(rng.normal(
                size=(b, n, mc.dim_text)).astype(np.float32)).to(device)
        x0, x1 = pairs(text, frames0, ctx, ctx_mask, mask, generator=x0_gen)
        loss = distiller.distill_step(x0, x1, lens=lens, text_embed=text,
                                      context=ctx, context_mask=ctx_mask)
        if step % 50 == 0:
            print(f"step {step}  reflow_loss {float(loss):.4f}", flush=True)
    save_model(args.out, student, step=distiller.step)
    print(f"saved reflow student -> {args.out} (sample with "
          f"V2APipeline.generate(fewstep=2))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
