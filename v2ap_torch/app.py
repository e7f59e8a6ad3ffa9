"""Web UI entry point: the HTTP server over the port's pipeline.

Counterpart of the root ``app.py``:

    python -m v2ap_torch.app [--host H] [--port 7860] [--tiny] [--cpu]

The pipeline's int8-tower default is JAX's, so set ``V2AP_INT8_TOWERS=0``
(bf16 towers, what the port serves).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch, no kernels)")
    args = ap.parse_args(argv)

    from v2ap_torch.predict import Predictor
    from v2ap_torch.serving.server import serve

    predictor = Predictor(tiny=args.tiny, device="cpu" if args.cpu else None)
    predictor.setup(args.ckpt)
    serve(predictor.pipeline, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
