"""Convert the reference's published CFM checkpoint into the port's layout.

    # a checkpoint in the reference's layout -> DIR/cfm (save_model), which
    # V2APipeline.load_weights(DIR) serves
    python -m v2ap_torch.convert --cfm-ckpt piano5_4_2_8000.pt --out ckpts/v2ap

    # the 88-key model (crossatt3_2)
    python -m v2ap_torch.convert --cfm-ckpt X.pt --out DIR --notes 88

    # the report of consumed and unconsumed keys, nothing written
    python -m v2ap_torch.convert --cfm-ckpt X.pt --audit

Counterpart of the CFM part of ``scripts/convert_checkpoints.py``. The CFM
is built structure-only (``create_model_zeros``) on the host at
``v2a_default()`` (``v2p_88key()`` with ``--notes 88``, the miniature
``tiny_tower_test()`` with ``--tiny``) and filled by
``utils.reference_ckpt.load_reference_checkpoint``; tensors the checkpoint
does not hold (a two-stream checkpoint's frames stream, Video2Roll where
the file has none) stay zero. The frozen encoders' flags (``--encodec``,
``--t5``, ``--clip``, ``--dinov2``, ``--convnext``, ``--pann``,
``--audioldm``) read Hugging Face snapshots through ``transformers``, which
the port does not use: they raise.
"""

from __future__ import annotations

import argparse
import json
import os

HF_FLAGS = ("encodec", "t5", "clip", "dinov2", "convnext", "pann", "audioldm")


def build_cfm(notes: int, tiny: bool = False):
    """The CFM of the shipped model (51 keys) or the 88-key one (or of the
    miniature ``tiny_tower_test()``), structure-only on the host, every
    tensor zero."""
    import dataclasses

    from v2ap_torch import config as cfglib
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.utils.jitting import create_model_zeros

    cfg = cfglib.tiny_tower_test() if tiny else cfglib.v2a_default()
    if notes == 88:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, notes=88, note_min=0, note_max=87))
    return create_model_zeros(lambda dev: CFM(
        cfg.model, cfg.conditioning, device=dev,
        with_video2roll=cfg.model.video2roll))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.convert")
    ap.add_argument("--cfm-ckpt", default=None,
                    help="the reference's .pt (model_state_dict layout)")
    ap.add_argument("--out", default=None,
                    help="output directory: the CFM goes to OUT/cfm")
    ap.add_argument("--notes", type=int, default=51, choices=(51, 88),
                    help="51 (shipped, crossatt3) or 88 (crossatt3_2)")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature model (tiny_tower_test())")
    ap.add_argument("--audit", action="store_true",
                    help="print the consumed / unconsumed key report for "
                         "--cfm-ckpt and exit without writing")
    for flag in HF_FLAGS:
        ap.add_argument(f"--{flag}", default=None,
                        help="not supported: needs transformers and a Hugging "
                             "Face snapshot")
    args = ap.parse_args(argv)
    hf = [f"--{f}" for f in HF_FLAGS if getattr(args, f) is not None]
    if hf:
        raise NotImplementedError(
            f"{', '.join(hf)}: converting the frozen encoders needs "
            f"transformers and Hugging Face snapshots, which the port does "
            f"not use")
    if not args.cfm_ckpt:
        ap.error("--cfm-ckpt is required")
    if not args.audit and not args.out:
        ap.error("--out is required unless --audit")

    import torch

    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.reference_ckpt import load_reference_checkpoint

    cfm = build_cfm(args.notes, args.tiny)
    if args.audit:
        from v2ap_torch.utils.reference_manifest import audit_state_dict

        ckpt = torch.load(args.cfm_ckpt, map_location="cpu",
                          weights_only=True, mmap=True)
        report = audit_state_dict(ckpt.get("model_state_dict", ckpt), cfm)
        print(json.dumps(report, indent=2))
        return 0 if not report["unexpected_unconsumed"] else 1

    leftovers = load_reference_checkpoint(args.cfm_ckpt, cfm)
    core_left = [k for k in leftovers
                 if not k.startswith(("text_encoder2.", "image_encoder.",
                                      "vocos."))]
    if core_left:
        print(f"WARNING: {len(core_left)} unconsumed core keys, e.g. "
              f"{core_left[:5]}")
    save_model(os.path.join(args.out, "cfm"), cfm)
    print(f"converted cfm core -> {os.path.join(args.out, 'cfm')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
