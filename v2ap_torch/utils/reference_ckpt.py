"""Load the reference's published CFM checkpoints
(``torch.load(ckpt)["model_state_dict"]`` of the torch + x_transformers
model) into the port's ``CFM``.

The port's own copy of ``v2ap_tpu/utils/reference_ckpt.py``, in torch. The
reference layout (for the shipped config: if_cross_attn, if_audio_conv,
if_text_conv, text_depth == depth):

  transformer.abs_pos_emb.weight                  (max_seq_len, dim)
  transformer.registers / text_registers / frames_registers
  transformer.time_cond_mlp.{0.weights, 1.weight, 1.bias}
  transformer.layers.{i}.0.{idx}   speech modules:
      0 skip_proj (later half) | 1 dwconv .dw_conv1d.0 | 2 attn_norm.to_gamma
      3 attn (to_q/to_k/to_v/to_out[.0]/to_v_head_gate) | 4 adaln.to_gamma
      5 cross_norm.to_gamma | 6 cross attn | 7 adaln2 | 8 ff_norm.to_gamma
      9 ff (.ff.0.proj + .ff.2) | 10 adaln_ff
  transformer.layers.{i}.1.{idx}   text modules:
      0 dwconv | 1 norm.g | 2 attn | 3 ff_norm.g | 4 ff | 5 cross_condition
        (.text_frames_to_audio/.audio_to_text/.audio_to_frames)
  transformer.layers.{i}.2.{idx}   frames modules: 0 dwconv | 1 norm.g
      | 2 attn | 3 ff_norm.g | 4 ff
  transformer.final_norm.g
  proj_in / cond_proj_in / to_pred / proj_frames (.weight/.bias)
  video2roll_net.*                               (trained piano net)
  text_encoder2.* / image_encoder.*              (frozen T5/CLIP copies)

Indices shift when a config drops a module (``_speech_index_map``,
``_text_index_map``). The port's layers store torch's (out, in) layout,
as the reference does, so a weight copies as it is, except: q/k rows of
the rotary attentions are permuted from the reference's interleaved
(GPT-J) rotary pairs to the half-split (NeoX) pairs of
``v2ap_torch.ops.rope`` (``_rope_permute``), and the self-attentions' q,
k, v stack into the fused ``to_qkv``. A two-stream checkpoint (crossatt,
crossatt6) has no frames stream: it loads into the tri-stream model with
the frames columns of the fusion, ``to_frames`` and ``proj_frames`` zero,
which makes the frames stream inert. Lookups try the historical
x_transformers names (``to_out.0``, ``to_v_gates``); every shape is
checked. The values may be numpy arrays or tensors, those on the ``meta``
device included (a structure-only audit). Unlike JAX's loader, the
Video2Roll part also consumes the BatchNorm ``num_batches_tracked``
counters, which every torch state dict carries and the port's BatchNorm
does not use.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# prefixes a strict load may leave: the frozen encoders' copies, heads the
# CFM does not hold, and crossatt6's FactorCL tower
_NOT_CORE = ("text_encoder2.", "image_encoder.", "vocos.", "mel_spec.",
             "embed_text.", "duration_predictor.",
             "transformer.contrastive_loss.")


class MissingKey(KeyError):
    pass


class _SD:
    """State-dict view with candidate-name resolution + usage tracking."""

    def __init__(self, sd: Dict[str, object]):
        self.sd = {k: v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.asarray(v))
                   for k, v in sd.items()}
        self.used = set()

    def get(self, *candidates: str) -> torch.Tensor:
        for c in candidates:
            if c in self.sd:
                self.used.add(c)
                return self.sd[c]
        raise MissingKey(f"none of {candidates} in checkpoint")

    def has(self, *candidates: str) -> bool:
        return any(c in self.sd for c in candidates)

    def unused(self, prefix: str = "") -> List[str]:
        return [k for k in self.sd if k.startswith(prefix)
                and k not in self.used]


@torch.no_grad()
def _put(dst: torch.Tensor, src: torch.Tensor, key: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _set_linear(mod, sd: _SD, key: str, bias: bool | None = None):
    _put(mod.weight, sd.get(f"{key}.weight"), f"{key}.weight")
    if bias is not False and sd.has(f"{key}.bias"):
        _put(mod.bias, sd.get(f"{key}.bias"), f"{key}.bias")


def _rope_permute(w: torch.Tensor, heads: int, dim_head: int,
                  rot_dim: int) -> torch.Tensor:
    """Reorder q/k projection OUTPUT rows from the reference's interleaved
    (GPT-J) rotary layout to the half-split (NeoX) one of ``ops.rope``.

    x-transformers (the reference's pinned 1.37.4) rotates adjacent
    feature pairs (2i, 2i+1); the port pairs (i, i + d/2). The rotations
    are related by a fixed per-head permutation P (R_neox = P R_gptj P^T),
    so permuting the checkpoint's q/k rows by P leaves every attention
    logit as the reference computes it. v, out and the gates are
    untouched. ``rot_dim`` is the rotary table's width: the reference
    sizes every stream's table from the AUDIO head width, so a stream with
    wider heads has partial rotary and only its first ``rot_dim`` features
    a head are permuted."""
    inner = heads * dim_head
    if w.shape[0] != inner or rot_dim % 2 or rot_dim > dim_head:
        raise ValueError(f"rope permutation: rows {w.shape[0]}, heads "
                         f"{heads} x {dim_head}, rot_dim {rot_dim}")
    idx = np.arange(inner).reshape(heads, dim_head)
    rot, tail = idx[:, :rot_dim], idx[:, rot_dim:]
    perm = np.concatenate([rot[:, 0::2], rot[:, 1::2], tail],
                          axis=1).reshape(-1)
    return w[torch.from_numpy(perm).to(w.device)]


def _set_attention(attn, sd: _SD, key: str, *, rotary: bool = True,
                   rot_dim: int | None = None):
    q = sd.get(f"{key}.to_q.weight")
    k = sd.get(f"{key}.to_k.weight")
    v = sd.get(f"{key}.to_v.weight")
    if rotary:
        rd = attn.dim_head if rot_dim is None else min(rot_dim, attn.dim_head)
        q = _rope_permute(q, attn.heads, attn.dim_head, rd)
        k = _rope_permute(k, attn.heads, attn.dim_head, rd)
    if attn.fused_qkv:
        _put(attn.to_qkv.weight, torch.cat([q, k, v], 0), f"{key}.to_qkv")
    else:
        _put(attn.to_q.weight, q, f"{key}.to_q")
        _put(attn.to_k.weight, k, f"{key}.to_k")
        _put(attn.to_v.weight, v, f"{key}.to_v")
    _put(attn.to_out.weight,
         sd.get(f"{key}.to_out.weight", f"{key}.to_out.0.weight"),
         f"{key}.to_out")
    if attn.to_v_gates is not None:
        names = [f"{key}.{g}" for g in ("to_v_head_gate", "to_v_gates",
                                        "to_value_head_gates")]
        _put(attn.to_v_gates.weight, sd.get(*(n + ".weight" for n in names)),
             f"{key}.to_v_gates")
        if sd.has(*(n + ".bias" for n in names)):
            _put(attn.to_v_gates.bias, sd.get(*(n + ".bias" for n in names)),
                 f"{key}.to_v_gates.bias")


def _set_ff(ff, sd: _SD, key: str):
    _set_linear(ff.proj_in, sd, f"{key}.ff.0.proj")
    _set_linear(ff.proj_out, sd, f"{key}.ff.2")


def _set_dwconv(conv, sd: _SD, key: str):
    _put(conv.weight, sd.get(f"{key}.dw_conv1d.0.weight"), key)  # (dim, 1, k)
    _put(conv.bias, sd.get(f"{key}.dw_conv1d.0.bias"), key)


def _set_rmsnorm(norm, sd: _SD, key: str):
    _put(norm.g, sd.get(f"{key}.g", f"{key}.gamma", f"{key}.weight"), key)


def _set_adanorm(norm, sd: _SD, key: str):
    _put(norm.to_gamma.weight, sd.get(f"{key}.to_gamma.weight"), key)


def _set_adaln_zero(gate, sd: _SD, key: str):
    _put(gate.to_gamma.weight, sd.get(f"{key}.to_gamma.weight"), key)
    _put(gate.to_gamma.bias, sd.get(f"{key}.to_gamma.bias"), key)


def _speech_index_map(if_audio_conv: bool,
                      if_cross_attn: bool) -> Dict[str, int]:
    """Position of each speech module in ``layers.{i}.0`` for a config
    (the reference's ModuleList construction)."""
    order = ["skip"]
    if if_audio_conv:
        order.append("conv")
    order += ["attn_norm", "attn", "attn_gate"]
    if if_cross_attn:
        order += ["cross_norm", "cross", "cross_gate"]
    order += ["ff_norm", "ff", "ff_gate"]
    return {name: i for i, name in enumerate(order)}


def _text_index_map(if_text_conv: bool) -> Dict[str, int]:
    """Positions in ``layers.{i}.1``."""
    order = (["conv"] if if_text_conv else []) + [
        "attn_norm", "attn", "ff_norm", "ff", "cross"]
    return {name: i for i, name in enumerate(order)}


@torch.no_grad()
def _set_cross_condition_two_stream(cc, sd: _SD, key: str, cfg) -> None:
    """A two-stream TextAudioCrossCondition (``text_to_audio`` over
    (audio, text), ``audio_to_text``) in the tri-stream module: the frames
    columns of ``to_audio`` and ``to_frames`` zero, so the frames stream
    is inert."""
    w = sd.get(f"{key}.text_to_audio.weight")          # (dim, dim + dim_text)
    full = torch.zeros((cfg.dim, cfg.dim + cfg.dim_text + cfg.dim_frames),
                       dtype=w.dtype, device=w.device)
    full[:, : cfg.dim + cfg.dim_text] = w
    _put(cc.to_audio.weight, full, f"{key}.text_to_audio")
    if cc.cond_audio_to_others:
        _put(cc.to_text.weight, sd.get(f"{key}.audio_to_text.weight"),
             f"{key}.audio_to_text")
        cc.to_frames.weight.zero_()


def load_cfm_from_reference_state_dict(sd_raw: Dict[str, object], cfm,
                                       strict: bool = False) -> List[str]:
    """Fill a ``v2ap_torch.models.cfm.CFM`` in place from the reference's
    ``model_state_dict`` (numpy arrays or tensors). Returns the checkpoint
    keys not consumed (the frozen encoder copies are expected there);
    ``strict`` raises on any unconsumed trainable-core key."""
    sd = _SD(sd_raw)
    t = cfm.transformer
    cfg = cfm.cfg
    speech_idx = _speech_index_map(cfg.if_audio_conv, cfg.if_cross_attn)
    text_idx = _text_index_map(cfg.if_text_conv)
    # a two-stream checkpoint fuses (audio, text) only: `text_to_audio`
    two_stream = not sd.has(
        "transformer.layers.0.1."
        f"{text_idx['cross']}.text_frames_to_audio.weight")

    if sd.has("transformer.abs_pos_emb.weight") and t.abs_pos_emb is not None:
        _put(t.abs_pos_emb.weight, sd.get("transformer.abs_pos_emb.weight"),
             "abs_pos_emb")
    _put(t.registers, sd.get("transformer.registers"), "registers")
    _put(t.text_registers, sd.get("transformer.text_registers"),
         "text_registers")
    if not two_stream:
        _put(t.frames_registers, sd.get("transformer.frames_registers"),
             "frames_registers")
    _put(t.time_mlp.fourier.weights,
         sd.get("transformer.time_cond_mlp.0.weights"), "time_cond_mlp.0")
    _set_linear(t.time_mlp.proj, sd, "transformer.time_cond_mlp.1")

    half = cfg.depth // 2
    for i in range(cfg.depth):
        sp = f"transformer.layers.{i}.0"
        blk = t.audio_blocks[i]
        if i >= half:
            _set_linear(blk.skip_proj, sd, f"{sp}.{speech_idx['skip']}",
                        bias=False)
        if "conv" in speech_idx and blk.conv is not None:
            _set_dwconv(blk.conv, sd, f"{sp}.{speech_idx['conv']}")
        _set_adanorm(blk.attn_norm, sd, f"{sp}.{speech_idx['attn_norm']}")
        _set_attention(blk.attn, sd, f"{sp}.{speech_idx['attn']}")
        _set_adaln_zero(blk.attn_gate, sd, f"{sp}.{speech_idx['attn_gate']}")
        if "cross_norm" in speech_idx and blk.cross_attn is not None:
            _set_adanorm(blk.cross_norm, sd,
                         f"{sp}.{speech_idx['cross_norm']}")
            # permuted too: with a context the permutation cancels in q.k;
            # without one the cross-attention runs as rotary self-attention
            _set_attention(blk.cross_attn, sd, f"{sp}.{speech_idx['cross']}")
            _set_adaln_zero(blk.cross_gate, sd,
                            f"{sp}.{speech_idx['cross_gate']}")
        _set_adanorm(blk.ff_norm, sd, f"{sp}.{speech_idx['ff_norm']}")
        _set_ff(blk.ff, sd, f"{sp}.{speech_idx['ff']}")
        _set_adaln_zero(blk.ff_gate, sd, f"{sp}.{speech_idx['ff_gate']}")

        if i < cfg.text_depth:
            tp = f"transformer.layers.{i}.1"
            tb = t.text_blocks[i]
            if "conv" in text_idx and tb.conv is not None:
                _set_dwconv(tb.conv, sd, f"{tp}.{text_idx['conv']}")
            _set_rmsnorm(tb.attn_norm, sd, f"{tp}.{text_idx['attn_norm']}")
            _set_attention(tb.attn, sd, f"{tp}.{text_idx['attn']}",
                           rot_dim=cfg.dim_head)
            _set_rmsnorm(tb.ff_norm, sd, f"{tp}.{text_idx['ff_norm']}")
            _set_ff(tb.ff, sd, f"{tp}.{text_idx['ff']}")
            cc = t.cross_conditions[i]
            ccp = f"{tp}.{text_idx['cross']}"
            if two_stream:
                _set_cross_condition_two_stream(cc, sd, ccp, cfg)
            else:
                _set_linear(cc.to_audio, sd, f"{ccp}.text_frames_to_audio",
                            bias=False)
                if cc.cond_audio_to_others:
                    _set_linear(cc.to_text, sd, f"{ccp}.audio_to_text",
                                bias=False)
                    _set_linear(cc.to_frames, sd, f"{ccp}.audio_to_frames",
                                bias=False)

        if not two_stream:
            fp = f"transformer.layers.{i}.2"
            fb = t.frames_blocks[i]
            _set_dwconv(fb.conv, sd, f"{fp}.0")
            _set_rmsnorm(fb.attn_norm, sd, f"{fp}.1")
            _set_attention(fb.attn, sd, f"{fp}.2", rot_dim=cfg.dim_head)
            _set_rmsnorm(fb.ff_norm, sd, f"{fp}.3")
            _set_ff(fb.ff, sd, f"{fp}.4")

    _set_rmsnorm(t.final_norm, sd, "transformer.final_norm")
    _set_linear(cfm.proj_in, sd, "proj_in")
    if cfm.cond_proj_in is not None and sd.has("cond_proj_in.weight"):
        _set_linear(cfm.cond_proj_in, sd, "cond_proj_in")
    _set_linear(cfm.to_pred, sd, "to_pred")
    if sd.has("proj_frames.weight"):
        _set_linear(cfm.proj_frames, sd, "proj_frames")
    elif two_stream:
        # no frames stream in the checkpoint: make the port's inert
        with torch.no_grad():
            cfm.proj_frames.weight.zero_()
            cfm.proj_frames.bias.zero_()
    if cfm.proj_text is not None and sd.has("proj_text.weight"):
        _set_linear(cfm.proj_text, sd, "proj_text")   # "mixed" encoder mode
    if cfm.video2roll is not None and sd.has("video2roll_net.conv1.weight"):
        _load_video2roll_flat(sd, "video2roll_net", cfm.video2roll)

    leftovers = sd.unused()
    if strict:
        core = [k for k in leftovers if not k.startswith(_NOT_CORE)]
        if core:
            raise MissingKey(f"unconsumed trainable-core keys: {core[:10]}")
    return leftovers


def _load_video2roll_flat(sd: _SD, prefix: str, net) -> None:
    """The reference's Video2RollNet keys (torch layouts, as the port's)."""
    def conv(mod, key):
        _put(mod.weight, sd.get(f"{prefix}.{key}.weight"), key)
        if sd.has(f"{prefix}.{key}.bias"):
            _put(mod.bias, sd.get(f"{prefix}.{key}.bias"), key)

    def bn(mod, key):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            _put(getattr(mod, leaf), sd.get(f"{prefix}.{key}.{leaf}"), key)
        if sd.has(f"{prefix}.{key}.num_batches_tracked"):
            sd.get(f"{prefix}.{key}.num_batches_tracked")

    def convbn(mod, ck, bk):
        conv(mod.conv, ck)
        bn(mod.bn, bk)

    def linear(mod, key):
        _put(mod.weight, sd.get(f"{prefix}.{key}.weight"), key)
        _put(mod.bias, sd.get(f"{prefix}.{key}.bias"), key)

    convbn(net.stem, "conv1", "bn1")
    for li, layer in enumerate((net.layer1, net.layer2, net.layer3,
                                net.layer4), start=1):
        for bi, blk in enumerate(layer):
            p = f"layer{li}.{bi}"
            convbn(blk.cb1, f"{p}.conv1", f"{p}.bn1")
            convbn(blk.cb2, f"{p}.conv2", f"{p}.bn2")
            if blk.down is not None:
                convbn(blk.down, f"{p}.downsample.0", f"{p}.downsample.1")
    for ftb, key in ((net.ftb2_1, "FTB2_1"), (net.ftb2_2, "FTB2_2"),
                     (net.ftb3, "FTB3"), (net.ftb4, "FTB4")):
        conv(ftb.conv0, f"{key}.conv0")
        convbn(ftb.cb1, f"{key}.conv1", f"{key}.bn1")
        conv(ftb.conv2, f"{key}.conv2")
    for frb, key in ((net.frb2, "FRB2"), (net.frb3, "FRB3"),
                     (net.frb4, "FRB4")):
        linear(frb.fc1, f"{key}.fc1")
        linear(frb.fc2, f"{key}.fc2")
    convbn(net.toplayer, "toplayer", "toplayer_bn")
    conv(net.conv2, "conv2")
    linear(net.fc, "fc")


def load_reference_checkpoint(path: str, cfm, strict: bool = False
                              ) -> List[str]:
    """``torch.load`` the published ``.pt`` (memory-mapped, on the host)
    and fill ``cfm``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return load_cfm_from_reference_state_dict(sd, cfm, strict=strict)
