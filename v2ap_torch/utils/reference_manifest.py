"""Expected key / shape manifests of the reference's four model-variant
checkpoints:

  crossatt    — two-stream T2A / V2A (no frames stream, no Video2Roll)
  crossatt6   — two-stream + the FactorCL contrastive tower
  crossatt3   — the shipped tri-stream V2A + V2P model (51 keys)
  crossatt3_2 — tri-stream, 88 keys

The port's own copy of ``v2ap_tpu/utils/reference_manifest.py``: used by
the loader's tests (synthetic state dicts with the exact names and shapes),
by ``chip_smoke.py`` to write a full-width synthetic ``.pt`` and by
``python -m v2ap_torch.convert --audit`` for the report of consumed and
unconsumed keys of a real one. Key layouts follow the reference's
conditional ModuleList construction; module indices shift with
if_audio_conv / if_cross_attn / if_text_conv exactly as in
``reference_ckpt._speech_index_map`` / ``_text_index_map``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from v2ap_torch.utils.reference_ckpt import (
    _speech_index_map, _text_index_map, load_cfm_from_reference_state_dict,
)

TWO_STREAM_VARIANTS = ("crossatt", "crossatt6")
TRI_STREAM_VARIANTS = ("crossatt3", "crossatt3_2")
ALL_VARIANTS = TWO_STREAM_VARIANTS + TRI_STREAM_VARIANTS


def reference_manifest(mc, variant: str = "crossatt3",
                       name_style: str = "modern") -> Dict[str, Tuple[int, ...]]:
    """key -> shape for a reference checkpoint of ``variant`` with model
    config ``mc`` (ModelConfig). ``name_style``: "modern" uses
    ``to_out.weight`` / ``to_v_head_gate``; "legacy" uses the historical
    x_transformers names ``to_out.0.weight`` / ``to_v_gates``."""
    assert variant in ALL_VARIANTS, variant
    two_stream = variant in TWO_STREAM_VARIANTS
    m: Dict[str, Tuple[int, ...]] = {}
    out_name = "to_out.weight" if name_style == "modern" else "to_out.0.weight"
    gate_name = ("to_v_head_gate" if name_style == "modern" else "to_v_gates")

    def attn(prefix, dim, heads, dim_head, dim_ctx=None):
        inner = heads * dim_head
        dim_ctx = dim_ctx or dim
        m[f"{prefix}.to_q.weight"] = (inner, dim)
        m[f"{prefix}.to_k.weight"] = (inner, dim_ctx)
        m[f"{prefix}.to_v.weight"] = (inner, dim_ctx)
        m[f"{prefix}.{out_name}"] = (dim, inner)
        m[f"{prefix}.{gate_name}.weight"] = (heads, dim)
        m[f"{prefix}.{gate_name}.bias"] = (heads,)

    def ff(prefix, dim, mult):
        inner = dim * mult
        m[f"{prefix}.ff.0.proj.weight"] = (inner * 2, dim)
        m[f"{prefix}.ff.0.proj.bias"] = (inner * 2,)
        m[f"{prefix}.ff.2.weight"] = (dim, inner)
        m[f"{prefix}.ff.2.bias"] = (dim,)

    def dwconv(prefix, dim, k):
        m[f"{prefix}.dw_conv1d.0.weight"] = (dim, 1, k)
        m[f"{prefix}.dw_conv1d.0.bias"] = (dim,)

    def adanorm(prefix, dim):
        m[f"{prefix}.to_gamma.weight"] = (dim, dim)

    def adaln_zero(prefix, dim):
        m[f"{prefix}.to_gamma.weight"] = (dim, dim)
        m[f"{prefix}.to_gamma.bias"] = (dim,)

    m["transformer.abs_pos_emb.weight"] = (mc.max_seq_len, mc.dim)
    m["transformer.registers"] = (mc.num_registers, mc.dim)
    m["transformer.text_registers"] = (mc.num_registers, mc.dim_text)
    if not two_stream:
        m["transformer.frames_registers"] = (mc.num_registers, mc.dim_frames)
    m["transformer.time_cond_mlp.0.weights"] = (mc.dim // 2,)
    m["transformer.time_cond_mlp.1.weight"] = (mc.dim, mc.dim + 1)
    m["transformer.time_cond_mlp.1.bias"] = (mc.dim,)

    sidx = _speech_index_map(mc.if_audio_conv, mc.if_cross_attn)
    tidx = _text_index_map(mc.if_text_conv)
    half = mc.depth // 2
    for i in range(mc.depth):
        sp = f"transformer.layers.{i}.0"
        if i >= half:
            m[f"{sp}.{sidx['skip']}.weight"] = (mc.dim, mc.dim * 2)
        if "conv" in sidx:
            dwconv(f"{sp}.{sidx['conv']}", mc.dim, mc.kernel_size)
        adanorm(f"{sp}.{sidx['attn_norm']}", mc.dim)
        attn(f"{sp}.{sidx['attn']}", mc.dim, mc.heads, mc.dim_head)
        adaln_zero(f"{sp}.{sidx['attn_gate']}", mc.dim)
        if "cross" in sidx:
            adanorm(f"{sp}.{sidx['cross_norm']}", mc.dim)
            attn(f"{sp}.{sidx['cross']}", mc.dim, mc.heads, mc.dim_head,
                 dim_ctx=mc.dim_context)
            adaln_zero(f"{sp}.{sidx['cross_gate']}", mc.dim)
        adanorm(f"{sp}.{sidx['ff_norm']}", mc.dim)
        ff(f"{sp}.{sidx['ff']}", mc.dim, mc.ff_mult)
        adaln_zero(f"{sp}.{sidx['ff_gate']}", mc.dim)

        if i < mc.text_depth:
            tp = f"transformer.layers.{i}.1"
            if "conv" in tidx:
                dwconv(f"{tp}.{tidx['conv']}", mc.dim_text, mc.kernel_size)
            m[f"{tp}.{tidx['attn_norm']}.g"] = (mc.dim_text,)
            attn(f"{tp}.{tidx['attn']}", mc.dim_text, mc.text_heads,
                 mc.text_dim_head)
            m[f"{tp}.{tidx['ff_norm']}.g"] = (mc.dim_text,)
            ff(f"{tp}.{tidx['ff']}", mc.dim_text, mc.text_ff_mult)
            cc = f"{tp}.{tidx['cross']}"
            if two_stream:
                m[f"{cc}.text_to_audio.weight"] = (
                    mc.dim, mc.dim + mc.dim_text)
                if i < mc.text_depth - 1:
                    m[f"{cc}.audio_to_text.weight"] = (
                        mc.dim_text, mc.dim + mc.dim_text)
            else:
                m[f"{cc}.text_frames_to_audio.weight"] = (
                    mc.dim, mc.dim + mc.dim_text + mc.dim_frames)
                if i < mc.text_depth - 1:
                    m[f"{cc}.audio_to_text.weight"] = (
                        mc.dim_text, mc.dim + mc.dim_text)
                    m[f"{cc}.audio_to_frames.weight"] = (
                        mc.dim_frames, mc.dim + mc.dim_frames)

        if not two_stream:
            fp = f"transformer.layers.{i}.2"
            dwconv(f"{fp}.0", mc.dim_frames, mc.kernel_size)
            m[f"{fp}.1.g"] = (mc.dim_frames,)
            attn(f"{fp}.2", mc.dim_frames, mc.frames_heads,
                 mc.frames_dim_head)
            m[f"{fp}.3.g"] = (mc.dim_frames,)
            ff(f"{fp}.4", mc.dim_frames, mc.frames_ff_mult)

    m["transformer.final_norm.g"] = (mc.dim,)
    m["proj_in.weight"] = (mc.dim, mc.num_channels)
    m["proj_in.bias"] = (mc.dim,)
    m["cond_proj_in.weight"] = (mc.dim, mc.num_channels)
    m["cond_proj_in.bias"] = (mc.dim,)
    m["to_pred.weight"] = (mc.num_channels, mc.dim)
    m["to_pred.bias"] = (mc.num_channels,)
    if not two_stream:
        m["proj_frames.weight"] = (mc.dim_frames, mc.notes)
        m["proj_frames.bias"] = (mc.dim_frames,)

    if variant == "crossatt6":
        # FactorCLSUP critic tower (multibench_model.py:150-178, executed:
        # scripts/derive_reference_keys.py): FactorCLSUP(None, [dim,
        # dim_text], y_ohe_dim=6) keeps only linears_club_x1x2_cond (two
        # mlp_head(d, d) = Linear/ReLU/Linear stacks) and club_x1x2_cond
        # (CLUBInfoNCECritic over concat(x1+ohe, x2+ohe) with hidden 512,
        # 1 layer). The CFM loader leaves these keys; no loader reads them
        # (training.contrastive's critic has two linears, this one three).
        y_ohe, hidden = 6, 512
        cl = "transformer.contrastive_loss"
        for j, d in ((0, mc.dim), (1, mc.dim_text)):
            for layer in (0, 2):
                m[f"{cl}.linears_club_x1x2_cond.{j}.{layer}.weight"] = (d, d)
                m[f"{cl}.linears_club_x1x2_cond.{j}.{layer}.bias"] = (d,)
        critic_in = mc.dim + mc.dim_text + 2 * y_ohe
        m[f"{cl}.club_x1x2_cond._f.0.weight"] = (hidden, critic_in)
        m[f"{cl}.club_x1x2_cond._f.0.bias"] = (hidden,)
        m[f"{cl}.club_x1x2_cond._f.2.weight"] = (hidden, hidden)
        m[f"{cl}.club_x1x2_cond._f.2.bias"] = (hidden,)
        m[f"{cl}.club_x1x2_cond._f.4.weight"] = (1, hidden)
        m[f"{cl}.club_x1x2_cond._f.4.bias"] = (1,)
    return m


def synthetic_state_dict(mc, variant: str = "crossatt3", seed: int = 0,
                         name_style: str = "modern") -> Dict[str, np.ndarray]:
    """Random tensors with the manifest's exact names and shapes."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=shape).astype(np.float32)
            for k, shape in reference_manifest(mc, variant, name_style).items()}


def audit_state_dict(sd: Dict[str, np.ndarray], cfm) -> dict:
    """Convert ``sd`` into ``cfm`` and report consumed/unconsumed keys."""
    leftovers = load_cfm_from_reference_state_dict(dict(sd), cfm)
    frozen = [k for k in leftovers if k.startswith(
        ("text_encoder2.", "image_encoder.", "vocos.", "mel_spec."))]
    # crossatt6's FactorCL critic heads are training-only aux params
    # (multibench_model.py FactorCLSUP); a CFM built without the contrastive
    # stack legitimately leaves them unconsumed — classified separately so a
    # crossatt6 checkpoint audits clean while a truly unknown key still flags
    aux = [k for k in leftovers
           if k.startswith("transformer.contrastive_loss.")]
    unexpected = [k for k in leftovers if k not in frozen and k not in aux]
    return {
        "total": len(sd),
        "consumed": len(sd) - len(leftovers),
        "frozen_copies_skipped": len(frozen),
        "aux_unconsumed": len(aux),
        "unexpected_unconsumed": unexpected,
    }
