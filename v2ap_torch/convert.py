"""Convert published weights into the port's layout.

    # a checkpoint in the reference's layout -> DIR/cfm (save_model), which
    # V2APipeline.load_weights(DIR) serves
    python -m v2ap_torch.convert --cfm-ckpt piano5_4_2_8000.pt --out ckpts/v2ap

    # Hugging Face snapshot directories already on disk -> DIR/<name>
    python -m v2ap_torch.convert --encodec /hf/facebook-encodec_24khz \
        --t5 /hf/google-flan-t5-large \
        --clip /hf/IP-Adapter/sdxl_models/image_encoder --out ckpts/v2ap

    # the 88-key model (crossatt3_2)
    python -m v2ap_torch.convert --cfm-ckpt X.pt --out DIR --notes 88

    # the report of consumed and unconsumed keys, nothing written
    python -m v2ap_torch.convert --cfm-ckpt X.pt --audit

    # the AudioLDM UNet of an audioldm-s-full checkpoint -> DIR/audioldm_unet
    python -m v2ap_torch.convert --audioldm audioldm-s-full.ckpt --out DIR

Counterpart of ``scripts/convert_checkpoints.py``. Each model is built
structure-only (``create_model_zeros``) on the host at its published width
(the miniatures with ``--tiny``), filled, and written with ``save_model``
under the name that ``V2APipeline.load_weights`` reads in both packages:
``--encodec`` -> ``encodec`` (the 24 kHz EnCodec), ``--t5`` -> ``t5``
(FLAN-T5-large's encoder), ``--clip`` -> ``clip`` (ViT-bigG), ``--dinov2``
-> ``dinov2`` (giant), ``--convnext`` -> ``clip_convnext`` (XXLarge, the
trunk; the open_clip head goes through
``utils.torch_convert.load_convnext_state_dict(head_state=)``), ``--pann``
-> ``pann`` (a ``Cnn14*.pth``: its ``model`` entry), ``--cfm-ckpt`` ->
``cfm``, ``--audioldm`` -> ``audioldm_unet`` (the ``state_dict`` entry's
``model.diffusion_model.*`` keys into the UNet of a
``LatentDiffusion(ldm_s_full())``, ``ldm_tiny_test()`` with ``--tiny``, the
whole ``LatentDiffusion`` written). A snapshot directory is read by
``utils.torch_convert.read_snapshot`` (safetensors, sharded or not, or
``pytorch_model.bin``); no ``transformers`` is needed. The CFM's tensors
that the checkpoint does not hold (a two-stream checkpoint's frames stream,
Video2Roll where the file has none) stay zero.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flag -> (directory name under OUT, what it reads)
ENCODER_FLAGS = {
    "encodec": ("encodec", "HF EncodecModel snapshot dir (24 kHz)"),
    "t5": ("t5", "HF T5 snapshot dir (FLAN-T5-large; the encoder is read)"),
    "clip": ("clip", "HF CLIPVisionModelWithProjection snapshot dir "
                     "(ViT-bigG)"),
    "dinov2": ("dinov2", "HF Dinov2Model snapshot dir (giant)"),
    "convnext": ("clip_convnext", "HF ConvNextModel snapshot dir (XXLarge, "
                                  "trunk only)"),
    "pann": ("pann", "Cnn14*.pth checkpoint (FAD embedder)"),
}


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


def tiny_encodec_config():
    """The miniature pipelines' codec (``V2APipeline`` with a latent width
    of 8)."""
    from v2ap_torch.models.encodec import EncodecConfig
    return EncodecConfig(hidden_size=8, num_filters=4,
                         upsampling_ratios=(8, 5, 4, 2), num_lstm_layers=1)


def _read_pann(sd, model) -> list:
    from v2ap_torch.evaluation.pann import load_pann_from_state_dict

    load_pann_from_state_dict(sd, model)
    return []


def build_encoder(flag: str, tiny: bool = False):
    """(structure-only module, its reader) for an encoder flag: the
    published width, or the miniature with ``tiny``."""
    from v2ap_torch.evaluation import pann
    from v2ap_torch.models import clip_vit, convnext, dinov2, encodec, t5
    from v2ap_torch.utils import torch_convert as tc
    from v2ap_torch.utils.jitting import create_model_zeros

    cls, full, small, reader = {
        "encodec": (encodec.EncodecModel, encodec.EncodecConfig,
                    tiny_encodec_config, tc.load_encodec_state_dict),
        "t5": (t5.T5Encoder, t5.flan_t5_large, t5.t5_tiny_test,
               tc.load_t5_state_dict),
        "clip": (clip_vit.CLIPVisionModel, clip_vit.clip_vit_bigg,
                 clip_vit.clip_tiny_test, tc.load_clip_vision_state_dict),
        "dinov2": (dinov2.Dinov2Model, dinov2.dinov2_giant,
                   dinov2.dinov2_tiny_test, tc.load_dinov2_state_dict),
        "convnext": (convnext.ConvNextCLIP, convnext.convnext_xxlarge,
                     convnext.convnext_tiny_test, tc.load_convnext_state_dict),
        "pann": (pann.Cnn14, pann.pann_16k, pann.pann_tiny_test, _read_pann),
    }[flag]
    cfg = (small if tiny else full)()
    return create_model_zeros(lambda d: cls(cfg, device=d)), reader


def convert_encoder(flag: str, src: str, out: str, tiny: bool = False) -> list:
    """Read ``src`` (a snapshot directory, or the ``.pth`` of ``--pann``),
    fill the encoder of ``flag`` and write it to ``out/<name>``; returns the
    keys the reader left over."""
    import torch

    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.torch_convert import read_snapshot

    model, reader = build_encoder(flag, tiny)
    if flag == "pann":
        ckpt = torch.load(src, map_location="cpu", weights_only=True)
        sd = ckpt.get("model", ckpt)
    else:
        sd = read_snapshot(src)
    left = reader(sd, model)
    save_model(os.path.join(out, ENCODER_FLAGS[flag][0]), model)
    return left


def convert_audioldm(src: str, out: str, tiny: bool = False) -> list:
    """Read an AudioLDM checkpoint (its ``state_dict`` entry, or the file's
    mapping itself), fill the UNet of a ``LatentDiffusion`` and write it to
    ``out/audioldm_unet``; returns the UNet keys left over."""
    import torch

    from v2ap_torch.models.latent_diffusion import (
        LatentDiffusion, ldm_s_full, ldm_tiny_test)
    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.jitting import create_model_zeros
    from v2ap_torch.utils.torch_convert import load_ldm_unet_from_state_dict

    cfg = ldm_tiny_test() if tiny else ldm_s_full()
    ldm = create_model_zeros(lambda d: LatentDiffusion(cfg, device=d))
    ckpt = torch.load(src, map_location="cpu", weights_only=True, mmap=True)
    left = load_ldm_unet_from_state_dict(ckpt.get("state_dict", ckpt),
                                         ldm.unet,
                                         prefix="model.diffusion_model.")
    save_model(os.path.join(out, "audioldm_unet"), ldm)
    return left


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.convert")
    ap.add_argument("--cfm-ckpt", default=None,
                    help="the reference's .pt (model_state_dict layout)")
    ap.add_argument("--out", default=None,
                    help="output directory: each model goes to OUT/<name>")
    ap.add_argument("--notes", type=int, default=51, choices=(51, 88),
                    help="51 (shipped, crossatt3) or 88 (crossatt3_2)")
    ap.add_argument("--tiny", action="store_true",
                    help="the miniature models (tiny_tower_test(), the "
                         "encoders' *_tiny_test(), ldm_tiny_test())")
    ap.add_argument("--audit", action="store_true",
                    help="print the consumed / unconsumed key report for "
                         "--cfm-ckpt and exit without writing")
    for flag, (_, what) in ENCODER_FLAGS.items():
        ap.add_argument(f"--{flag}", default=None, help=what)
    ap.add_argument("--audioldm", default=None,
                    help="AudioLDM checkpoint (audioldm-s-full): its UNet "
                         "-> OUT/audioldm_unet")
    args = ap.parse_args(argv)
    encoders = [f for f in ENCODER_FLAGS if getattr(args, f) is not None]
    if args.audit:
        if not args.cfm_ckpt:
            ap.error("--audit requires --cfm-ckpt")
    elif not args.out:
        ap.error("--out is required unless --audit")
    if not args.cfm_ckpt and not encoders and not args.audioldm:
        ap.error("nothing to convert: give --cfm-ckpt, --audioldm or an "
                 "encoder flag")

    import torch

    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.reference_ckpt import load_reference_checkpoint

    if args.audit:
        from v2ap_torch.utils.reference_manifest import audit_state_dict

        cfm = build_cfm(args.notes, args.tiny)
        ckpt = torch.load(args.cfm_ckpt, map_location="cpu",
                          weights_only=True, mmap=True)
        report = audit_state_dict(ckpt.get("model_state_dict", ckpt), cfm)
        print(json.dumps(report, indent=2))
        return 0 if not report["unexpected_unconsumed"] else 1

    for flag in encoders:
        t0 = time.perf_counter()
        left = convert_encoder(flag, getattr(args, flag), args.out, args.tiny)
        name = os.path.join(args.out, ENCODER_FLAGS[flag][0])
        print(f"converted {flag} -> {name} in "
              f"{time.perf_counter() - t0:.3f} s; {len(left)} keys not used"
              + (f", e.g. {left[:3]}" if left else ""))

    if args.audioldm:
        t0 = time.perf_counter()
        left = convert_audioldm(args.audioldm, args.out, args.tiny)
        print(f"converted audioldm ldm unet -> "
              f"{os.path.join(args.out, 'audioldm_unet')} in "
              f"{time.perf_counter() - t0:.3f} s; {len(left)} keys not used"
              + (f", e.g. {left[:3]}" if left else ""))

    if args.cfm_ckpt:
        cfm = build_cfm(args.notes, args.tiny)
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
