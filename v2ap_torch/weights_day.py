"""The weights-day runbook: what must happen the day the published
checkpoints are on disk, chained so that nothing is improvised:

    convert -> audit -> forward smoke -> checkpoint round trip ->
    int8 end-audio gate -> reflow distillation -> bench

Real run (the port's CLIs, one after the other; a stage that fails stops
the convert / smoke chain):

    python -m v2ap_torch.weights_day --ckpt piano5_4_2_8000.pt \\
        --out ckpts/v2ap --encodec /hf/facebook-encodec_24khz \\
        --t5 /hf/google-flan-t5-large --clip /hf/IP-Adapter/image_encoder \\
        --videos clips/ [--notes 51] [--distill-steps 2000]

Dry run: synthetic state dicts in the reference's layout for all four
variants (``utils.reference_manifest``), saved as real ``.pt`` files and
driven through every stage at tiny scale:

    python -m v2ap_torch.weights_day --dry-run --workdir DIR --device cpu

Counterpart of ``scripts/weights_day.py``. For each variant the dry run
converts and audits the ``.pt`` (``load_reference_checkpoint``,
``audit_state_dict``: ``strict=False``, the frozen encoders' copies and
crossatt6's FactorCL heads reported, an unknown key a failure), samples
2 steps from it (finite, and bit-equal from a second independent load),
and round-trips it through ``save_model`` / ``load_model``; then the int8
gate (``python -m v2ap_torch.int8_tower_gate --tiny --dry``) on a written
clip (skipped without a video writer) and 3 reflow steps (``python -m
v2ap_torch.distill --tiny``) on the converted crossatt3 model, both CLIs'
``main`` run in this process. The port
has no benchmark yet, so the bench stage says so in both modes. The last
line of the output is one JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np


def _cli(stage: str, module: str, args: list, summary: dict,
         timeout: int = 3600, in_process: bool = False) -> bool:
    """``python -m <module> <args>`` as a stage of the run; with
    ``in_process`` the module's ``main(args)`` in this process (the dry
    run: no interpreter start a stage)."""
    print(f"==> {stage}: python -m {module} {' '.join(args)}", flush=True)
    if in_process:
        import contextlib
        import importlib
        import io
        import traceback

        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                ok = importlib.import_module(module).main(args) == 0
        except Exception:                      # the stage's failure
            ok = False
            buf.write(traceback.format_exc())
        text = buf.getvalue()
    else:
        try:
            proc = subprocess.run([sys.executable, "-m", module, *args],
                                  timeout=timeout, text=True,
                                  capture_output=True)
        except (OSError, subprocess.TimeoutExpired) as exc:
            summary[stage] = {"ok": False,
                              "error": f"{type(exc).__name__}: {exc}"}
            return False
        ok, text = proc.returncode == 0, proc.stdout + proc.stderr
    tail = text.strip().splitlines()[-6:]
    summary[stage] = {"ok": ok, "tail": tail}
    if not ok:
        print(f"FAILED ({stage}):\n" + "\n".join(tail), flush=True)
    return ok


BENCH_NOTE = ("the port has no benchmark yet; chip_smoke.py drives it on "
              "the card")


def dry_run(workdir: str, device: str) -> int:
    """The tiny-scale rehearsal of the whole chain over the four
    variants."""
    import torch

    from v2ap_torch.config import SamplerConfig
    from v2ap_torch.convert import build_cfm
    from v2ap_torch.utils.checkpoint import load_model, save_model
    from v2ap_torch.utils.reference_ckpt import load_reference_checkpoint
    from v2ap_torch.utils.reference_manifest import (
        ALL_VARIANTS, audit_state_dict, synthetic_state_dict)

    os.makedirs(workdir, exist_ok=True)
    summary: dict = {}
    dev = torch.device(device)
    b, n = 1, 32
    rng = np.random.default_rng(0)
    ok_all = True
    for variant in ALL_VARIANTS:
        notes = 88 if variant == "crossatt3_2" else 51

        def build():
            return build_cfm(notes, tiny=True)

        mc = build().cfg
        # one set of inputs a variant: every forward sees the same data
        x0 = torch.from_numpy(rng.normal(size=(b, n, mc.num_channels))
                              .astype(np.float32)).to(dev)
        text = torch.from_numpy(rng.normal(size=(b, n, mc.dim_text))
                                .astype(np.float32)).to(dev)

        @torch.no_grad()
        def forward(model):
            model = model.to(dev)
            return model.sample(
                x0, text_embed=text,
                frames_embed=torch.zeros(b, n, mc.notes, device=dev),
                context=torch.zeros(b, 1, mc.dim_context, device=dev),
                context_mask=torch.ones(b, 1, dtype=torch.bool, device=dev),
                mask=None, sampler=SamplerConfig(steps=2, cfg_strength=1.0)
            ).cpu().numpy()

        # 1. the reference layout as a real .pt (torch.load ->
        # model_state_dict -> strict=False)
        sd = synthetic_state_dict(mc, variant)
        pt = os.path.join(workdir, f"{variant}.pt")
        torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                         for k, v in sd.items()}}, pt)
        # 2. convert + 3. audit
        model = build()
        leftovers = load_reference_checkpoint(pt, model)
        report = audit_state_dict(sd, build())
        ok = not report["unexpected_unconsumed"]
        # 4. forward smoke: finite, and a second load gives the same bits
        out1 = forward(model)
        model2 = build()
        load_reference_checkpoint(pt, model2)
        ok = ok and bool(np.isfinite(out1).all()
                         and np.array_equal(out1, forward(model2)))
        # 5. save_model -> load_model (what V2APipeline.load_weights reads)
        cfm_dir = os.path.join(workdir, f"ckpt_{variant}", "cfm")
        save_model(cfm_dir, model)
        model3 = build()
        load_model(cfm_dir, model3)
        ok = ok and bool(np.array_equal(out1, forward(model3)))
        summary[f"convert_{variant}"] = {
            "ok": bool(ok), "leftovers": len(leftovers),
            "aux_unconsumed": report["aux_unconsumed"],
            "unexpected": report["unexpected_unconsumed"][:5]}
        ok_all = ok_all and ok
        print(f"==> convert+audit+forward+roundtrip {variant}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)

    # 6. the int8 end-audio gate (tiny stack, verdict not written)
    video = os.path.join(workdir, "clip.mp4")
    if _write_clip(video):
        ok_all &= _cli("int8_gate", "v2ap_torch.int8_tower_gate", [
            "--tiny", "--dry", "--videos", video, "--steps", "2",
            "--device", device], summary, in_process=True)
    else:
        summary["int8_gate"] = {"ok": True, "skipped": "no video writer"}
    # 7. reflow distillation on the converted shipped variant
    ok_all &= _cli("distill", "v2ap_torch.distill", [
        "--tiny", "--ckpt", os.path.join(workdir, "ckpt_crossatt3", "cfm"),
        "--out", os.path.join(workdir, "cfm_reflow"), "--steps", "3",
        "--batch", "2", "--frames", "32", "--teacher-steps", "2",
        "--device", device], summary, in_process=True)
    summary["bench"] = {"ok": True, "note": BENCH_NOTE}
    print(json.dumps({"dry_run_ok": bool(ok_all), "stages": summary}),
          flush=True)
    return 0 if ok_all else 1


def _write_clip(path: str, seconds: float = 2.0, fps: int = 8,
                size=(64, 48)) -> bool:
    """A short moving-gradient mp4 for the gate (cv2's writer), or False
    where there is none."""
    try:
        import cv2
    except ImportError:
        return False
    w, h = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        return False
    for i in range(int(seconds * fps)):
        x = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
        frame = np.broadcast_to((x + 8 * i) % 256, (h, w, 3))
        writer.write(frame.astype(np.uint8))
    writer.release()
    return os.path.exists(path) and os.path.getsize(path) > 0


def real_run(args) -> int:
    summary: dict = {}
    dev = ["--device", args.device] if args.device else []
    # 1. the audit first: a surprising key inventory stops the day early
    if args.ckpt and not _cli("audit", "v2ap_torch.convert", [
            "--audit", "--cfm-ckpt", args.ckpt, "--notes", str(args.notes)],
            summary):
        print(json.dumps(summary))
        return 1
    # 2. convert everything given
    conv = ["--out", args.out, "--notes", str(args.notes)]
    for flag in ("ckpt", "encodec", "t5", "clip", "dinov2", "convnext",
                 "pann", "audioldm"):
        val = getattr(args, flag)
        if val:
            conv += [f"--{'cfm-ckpt' if flag == 'ckpt' else flag}", val]
    if not _cli("convert", "v2ap_torch.convert", conv, summary):
        print(json.dumps(summary))
        return 1
    # 3. forward smoke through the serving pipeline: the full-size load and
    # one short generation
    smoke = (
        "import numpy as np;"
        "from v2ap_torch.config import V2APConfig;"
        "from v2ap_torch.pipelines.generate import V2APipeline;"
        f"p=V2APipeline(V2APConfig(), device={args.device!r});"
        f"print('loaded:', p.load_weights({args.out!r}));"
        "wav,sr=p.generate(None, 'the sound of rain', duration_s=2.0,"
        "steps=4);"
        "assert np.isfinite(wav).all();"
        "print('smoke wav rms', float(np.sqrt(np.mean(wav**2))))")
    print("==> forward_smoke", flush=True)
    try:
        proc = subprocess.run([sys.executable, "-c", smoke], text=True,
                              capture_output=True, timeout=3600)
        summary["forward_smoke"] = {
            "ok": proc.returncode == 0,
            "tail": (proc.stdout + proc.stderr).strip().splitlines()[-6:]}
    except subprocess.TimeoutExpired as exc:
        summary["forward_smoke"] = {"ok": False, "error": str(exc)}
    if not summary["forward_smoke"]["ok"]:
        print(json.dumps(summary))
        return 1
    # 4. the int8 end-audio gate (writes the gate file serving consults)
    if args.videos:
        _cli("int8_gate", "v2ap_torch.int8_tower_gate", [
            "--ckpt", args.out, "--videos", args.videos,
            "--steps", str(args.steps), *dev], summary)
    # 5. reflow-distil the few-step student
    if args.distill_steps > 0:
        _cli("distill", "v2ap_torch.distill", [
            "--ckpt", os.path.join(args.out, "cfm"),
            "--out", os.path.join(args.out, "cfm_reflow"),
            "--steps", str(args.distill_steps), *dev], summary)
    summary["bench"] = {"ok": True, "note": BENCH_NOTE}
    ok = all(s.get("ok") for s in summary.values())
    print(json.dumps({"weights_day_ok": ok, "stages": summary}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.weights_day")
    ap.add_argument("--dry-run", action="store_true",
                    help="rehearse the whole chain on synthetic state dicts "
                         "of the four variants (tiny scale)")
    ap.add_argument("--workdir", default=None,
                    help="the dry run's directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckpt", default=None, help="the reference's .pt")
    ap.add_argument("--out", default="ckpts/v2ap")
    ap.add_argument("--notes", type=int, default=51)
    for flag in ("encodec", "t5", "clip", "dinov2", "convnext", "pann",
                 "audioldm"):
        ap.add_argument(f"--{flag}", default=None)
    ap.add_argument("--videos", default=None,
                    help="the gate's clips (a directory or a glob)")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--distill-steps", type=int, default=0,
                    help="reflow-distillation steps (0: skip)")
    args = ap.parse_args(argv)
    if args.dry_run:
        from v2ap_torch.utils.device import resolve_device

        device = str(resolve_device(args.device))
        workdir = args.workdir or tempfile.mkdtemp(prefix="v2ap_weights_day_")
        return dry_run(workdir, device)
    if not (args.ckpt or args.encodec or args.t5 or args.clip):
        ap.error("nothing to convert (or use --dry-run)")
    return real_run(args)


if __name__ == "__main__":
    raise SystemExit(main())
