"""Video-to-audio batch inference CLI of the port.

The reference's argv (``ckpt drop_prompt test_scp start end out_dir
[step]``) and flags, as ``inference_v2a.py`` takes them:

    python -m v2ap_torch.inference_v2a ckpts/model 0 tests/vgg_test.scp 0 100 outputs/
    python -m v2ap_torch.inference_v2a --ckpt ckpts/model --scp tests/vgg_test.scp \\
        --start 0 --end 100 --out outputs/ --steps 64 --cfg 2.0

    # the CPU-runnable miniature (random weights)
    python -m v2ap_torch.inference_v2a --tiny --device cpu --scp eval.scp --out o/

The pipeline runs on CUDA unless ``--device`` says otherwise, with bf16 towers
(the batch-eval numerics; the port has no int8 towers), and loads
``--ckpt`` with ``V2APipeline.load_weights`` (the port's checkpoint
layout). After the positional arguments the port takes ``--device``,
``--steps`` and ``--tiny`` (``... out_dir --device cpu --steps 25``).
Videos are read as ``V2APipeline.generate`` reads them: from the caches
beside them, else decoded with cv2. Exits 1 when any clip failed.
"""

from __future__ import annotations

import argparse
import sys

_POSITIONAL_DEFAULTS = dict(steps=64, cfg=2.0, piano=False, seed=0, passes=1,
                            raw_captions=False)


def _split(argv):
    """(leading positional arguments, the flags after them)."""
    n = next((i for i, a in enumerate(argv) if a.startswith("--")), len(argv))
    return list(argv[:n]), list(argv[n:])


def _port_flags(argv) -> argparse.Namespace:
    """The port's own options after the reference's positional form."""
    p = argparse.ArgumentParser(prog="python -m v2ap_torch.inference_v2a")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None)
    p.add_argument("--steps", type=int, default=None)
    return p.parse_args(argv)


def parse_args(argv):
    pos, flags = _split(argv)
    # the reference-compatible positional form
    if len(pos) >= 6 and not argv[0].startswith("-"):
        ns = argparse.Namespace(
            ckpt=pos[0], drop_prompt=bool(int(pos[1])), scp=pos[2],
            start=int(pos[3]), end=int(pos[4]), out=pos[5],
            step=int(pos[6]) if len(pos) > 6 else 1, **_POSITIONAL_DEFAULTS)
        extra = _port_flags(flags)
        ns.device = extra.device
        if extra.tiny:
            ns.tiny = True
        if extra.steps is not None:
            ns.steps = extra.steps
        return ns
    p = argparse.ArgumentParser(prog="python -m v2ap_torch.inference_v2a",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", default=None,
                   help="model directory (V2APipeline.load_weights)")
    p.add_argument("--drop-prompt", dest="drop_prompt", action="store_true")
    p.add_argument("--scp", required=True, help="video_path\\tcaption manifest")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--step", type=int, default=1,
                   help="manifest stride (reference vgg_test[3])")
    p.add_argument("--raw-captions", dest="raw_captions", action="store_true",
                   help="skip the reference's 'the sound of ' caption prefix")
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--cfg", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--piano", action="store_true")
    p.add_argument("--passes", type=int, default=1,
                   help="multi-pass refinement sampling (restart passes)")
    p.add_argument("--tiny", action="store_true",
                   help="miniature debug config (random weights, CPU-friendly)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def build_pipeline(tiny: bool, device=None):
    """The shipped V2APConfig() with bf16 towers, or with ``tiny`` the
    miniature of the JAX CLIs (tiny_test() with 16-d text, a 32-d context,
    8 latent channels, the tiny T5 and CLIP)."""
    from v2ap_torch import config as cfglib
    from v2ap_torch.pipelines.generate import V2APipeline

    if tiny:
        import dataclasses

        from v2ap_torch.models.clip_vit import clip_tiny_test
        from v2ap_torch.models.t5 import t5_tiny_test
        cfg = cfglib.tiny_test()
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, dim_text=16, dim_context=32, num_channels=8))
        return V2APipeline(cfg, device=device, quantize_towers=False,
                           t5_config=t5_tiny_test(),
                           clip_config=clip_tiny_test())
    return V2APipeline(cfglib.V2APConfig(), device=device,
                       quantize_towers=False)


def run(args) -> int:
    from v2ap_torch.pipelines.batch_eval import run_batch_eval

    pipeline = build_pipeline(getattr(args, "tiny", False), args.device)
    if args.ckpt:
        pipeline.load_weights(args.ckpt)
    summary = run_batch_eval(
        pipeline, args.scp, args.out, start=args.start, end=args.end,
        step=args.step,
        caption_prefix="" if args.raw_captions else "the sound of ",
        steps=args.steps, cfg_strength=args.cfg,
        drop_prompt=args.drop_prompt, piano=args.piano, seed=args.seed,
        passes=args.passes)
    print(summary)
    return 0 if summary["failed"] == 0 else 1


def main(argv=None) -> int:
    return run(parse_args(argv if argv is not None else sys.argv[1:]))


if __name__ == "__main__":
    raise SystemExit(main())
