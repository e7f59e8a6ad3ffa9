"""The int8-tower end-audio quality gate (``evaluation/int8_gate.py``).

    python -m v2ap_torch.int8_tower_gate --ckpt ckpts/converted \\
        --videos clips/ --steps 25 --bound-fad 1.0

    # the miniature stack on the CPU, verdict printed and not written
    python -m v2ap_torch.int8_tower_gate --videos clip.mp4 --tiny \\
        --device cpu --dry

Counterpart of ``scripts/int8_tower_gate.py``: every clip is generated
twice (bf16 towers, then int8 towers, same seed), FAD(int8 | bf16) is
scored on Cnn14 embeddings (plus the mean CLAP delta with ``--prompts``)
and the verdict goes to the gate file ``V2APipeline`` consults. The
evaluators' weights are seeded unless ``V2AP_PANN_WEIGHTS`` /
``V2AP_CLAP_WEIGHTS`` name published files, and ``--tiny`` builds the
miniatures: then the verdict checks the plumbing only. ``--device``
(default: CUDA) is the port's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.int8_tower_gate")
    ap.add_argument("--ckpt", default=None,
                    help="converted checkpoint dir (load_weights layout)")
    ap.add_argument("--videos", required=True,
                    help="video file, directory, or glob")
    ap.add_argument("--prompts", default=None,
                    help="optional text file, one prompt per clip")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bound-fad", type=float, default=1.0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny test stack (no real weights; plumbing check)")
    ap.add_argument("--dry", action="store_true",
                    help="print the verdict without writing the gate file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if os.path.isdir(args.videos):
        videos = sorted(glob.glob(os.path.join(args.videos, "*.mp4")))
    else:
        videos = sorted(glob.glob(args.videos)) or [args.videos]
    videos = [v for v in videos if os.path.getsize(v) > 1024]  # LFS stubs
    if not videos:
        raise SystemExit("no usable clips (LFS stubs excluded)")
    prompts = None
    if args.prompts:
        with open(args.prompts) as f:
            prompts = [line.strip() for line in f][: len(videos)]

    from v2ap_torch.evaluation.int8_gate import run_gate
    from v2ap_torch.evaluation.pann import make_embedder, pann_tiny_test
    from v2ap_torch.predict import Predictor

    # V2APConfig(), or the miniature stack; then the converted weights
    predictor = Predictor(tiny=args.tiny, device=args.device)
    predictor.setup(args.ckpt)
    pipe = predictor.pipeline
    embedder = make_embedder(pann_tiny_test() if args.tiny else None,
                             device=pipe.device)
    verdict = run_gate(pipe, videos, prompts, steps=args.steps,
                       seed=args.seed, bound_fad=args.bound_fad,
                       embedder=embedder, write=not args.dry)
    print(json.dumps(verdict))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
