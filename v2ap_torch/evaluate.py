"""Evaluation CLI of the port: batch-generate over a manifest and score.

    python -m v2ap_torch.evaluate --scp tests/vgg_test.scp --out outputs/ \\
        --steps 64 [--piano] [--ref-dir reference_wavs/] [--clap]

    # the CPU-runnable miniature (random weights)
    python -m v2ap_torch.evaluate --tiny --device cpu --scp eval.scp \\
        --out o/ --steps 2 --ref-dir refs/ --clap

Counterpart of ``scripts/evaluate.py``. Always the realtime factor; with
``--ref-dir`` FAD and IS from one PANN Cnn14 pass per wav (reference
statistics from the whole directory) and the softmax / sigmoid KL with
generated and reference wavs paired by basename; with ``--clap`` a CLAP
caption-audio score per clip. Evaluators run on the pipeline's device in
float32, from ``$V2AP_PANN_WEIGHTS`` / ``$V2AP_CLAP_WEIGHTS`` when set,
else from seed 0 (numbers for plumbing, not for comparison). Writes
``summary.json`` (with ``metrics_seconds``, the FAD / IS / KL block's
seconds) into ``--out`` and prints it as JSON.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.evaluate")
    ap.add_argument("--scp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--cfg", type=float, default=2.0)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--piano", action="store_true")
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ref-dir", default=None,
                    help="reference wavs for FAD / IS / KL (built-in PANN "
                         "Cnn14; set $V2AP_PANN_WEIGHTS for absolute numbers)")
    ap.add_argument("--clap", action="store_true",
                    help="per-clip CLAP caption-audio scores (registers the "
                         "built-in scorer; set $V2AP_CLAP_WEIGHTS for real "
                         "numbers)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from v2ap_torch.data import clap_filter
    from v2ap_torch.data.audio_io import read_wav
    from v2ap_torch.evaluation import metrics
    from v2ap_torch.evaluation.pann import make_joint
    from v2ap_torch.inference_v2a import build_pipeline
    from v2ap_torch.pipelines.batch_eval import run_batch_eval

    pipeline = build_pipeline(args.tiny, args.device)
    if args.ckpt:
        pipeline.load_weights(args.ckpt)
    device = pipeline.device
    if args.clap and not clap_filter.has_scorer():
        from v2ap_torch.evaluation.clap_scorer import make_clap_scorer
        clap_filter.set_scorer(make_clap_scorer(device=device))

    summary = run_batch_eval(
        pipeline, args.scp, args.out, start=args.start, end=args.end,
        steps=args.steps, cfg_strength=args.cfg, piano=args.piano,
        passes=args.passes, clap_scores=args.clap)

    if args.ref_dir:
        t0 = time.perf_counter()
        try:
            gen_paths = sorted(glob.glob(os.path.join(args.out, "*.wav")))
            ref_paths = sorted(glob.glob(os.path.join(args.ref_dir, "*.wav")))
            gen = [read_wav(p)[0][0] for p in gen_paths]
            ref = [read_wav(p)[0][0] for p in ref_paths]
            # one Cnn14 pass per wav serves every metric
            joint = make_joint(device=device)

            def run_all(wavs):
                outs = [joint(w, 24_000) for w in wavs]
                return (np.concatenate([np.atleast_2d(e) for e, _ in outs]),
                        np.concatenate([np.atleast_2d(l) for _, l in outs]))

            ref_emb, ref_logits = run_all(ref)
            gen_emb, gen_logits = run_all(gen)
            summary["fad"] = metrics.fad_from_embeddings(ref_emb, gen_emb)
            is_mean, is_std = metrics.inception_score(gen_logits)
            summary["is_mean"], summary["is_std"] = is_mean, is_std
            ref_idx = {os.path.basename(p): i
                       for i, p in enumerate(ref_paths)}
            pair_rows = [ref_idx.get(os.path.basename(p))
                         for p in gen_paths]
            if gen_paths and all(i is not None for i in pair_rows):
                r_log = ref_logits[np.asarray(pair_rows)]
                summary["kl_softmax"] = metrics.kl_softmax(r_log, gen_logits)
                summary["kl_sigmoid"] = metrics.kl_sigmoid(r_log, gen_logits)
        except (RuntimeError, ValueError) as exc:
            summary["fad_error"] = str(exc)
        summary["metrics_seconds"] = round(time.perf_counter() - t0, 3)

    print(json.dumps(summary))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
