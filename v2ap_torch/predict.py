"""Cog-style Predictor API over the port's pipeline.

Counterpart of the root ``predict.py``:

    from v2ap_torch.predict import Predictor
    p = Predictor()                        # device=None: CUDA
    p.setup()                              # builds the model stack
    out = p.predict(video="clip.mp4", prompt="rain", v2a_num_steps=25,
                    if_piano=False)        # -> path to generated media

    python -m v2ap_torch.predict clip.mp4 [--tiny] [--cpu] [--steps N]

``tiny=True`` builds the port's miniature configs (CPU-sized). The
pipeline's int8-tower default is JAX's: set ``V2AP_INT8_TOWERS=0`` (bf16
towers, what the port serves) or it raises. A checkpoint (``ckpt``)
raises: loading weights is not ported yet.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional


class Predictor:
    def __init__(self, cfg=None, tiny: bool = False, device=None):
        self._cfg = cfg
        self._tiny = tiny
        self._device = device
        self.pipeline = None

    def setup(self, ckpt: Optional[str] = None) -> None:
        if ckpt:
            raise NotImplementedError("loading weights (V2APipeline."
                                      "load_weights) is not ported yet")
        from v2ap_torch.config import V2APConfig
        from v2ap_torch.pipelines.generate import V2APipeline

        if self._tiny:
            import dataclasses

            from v2ap_torch import config as cfglib
            from v2ap_torch.models.clip_vit import clip_tiny_test
            from v2ap_torch.models.t5 import t5_tiny_test
            cfg = cfglib.tiny_test()
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, dim_text=16, dim_context=32, num_channels=8))
            self.pipeline = V2APipeline(cfg, device=self._device,
                                        t5_config=t5_tiny_test(),
                                        clip_config=clip_tiny_test())
        else:
            self.pipeline = V2APipeline(self._cfg or V2APConfig(),
                                        device=self._device)

    def predict(self, video: str, prompt: str = "",
                v2a_num_steps: int = 25, if_piano: bool = False,
                out_dir: Optional[str] = None, seed: int = 0,
                fewstep: Optional[int] = None) -> str:
        """Generate for ``video`` and write ``<stem>.generated.mp4`` in
        ``out_dir`` (a new temporary directory when None), or the
        ``.generated.wav`` beside it when no muxer is installed; returns the
        path written. ``fewstep=N`` serves N uniform Euler steps without
        CFG (the distilled-student mode)."""
        if self.pipeline is None:
            raise RuntimeError("call setup() first")
        from v2ap_torch.data.video_io import mux_audio_onto_video

        out_dir = out_dir or tempfile.mkdtemp(prefix="v2ap_")
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(video))[0]
        out_path = os.path.join(out_dir, f"{stem}.generated.mp4")
        wav, sr = self.pipeline.generate(
            video, prompt, steps=v2a_num_steps, piano=if_piano, seed=seed,
            fewstep=fewstep)
        muxed = mux_audio_onto_video(video, wav, sr, out_path)
        return out_path if muxed else os.path.splitext(out_path)[0] + ".wav"


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("--prompt", default="")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--piano", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch, no kernels)")
    ap.add_argument("--fewstep", type=int, default=None,
                    help="distilled serving: N uniform steps, no CFG")
    args = ap.parse_args(argv)
    p = Predictor(tiny=args.tiny, device="cpu" if args.cpu else None)
    p.setup(args.ckpt)
    print(p.predict(args.video, args.prompt, args.steps, args.piano,
                    fewstep=args.fewstep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
