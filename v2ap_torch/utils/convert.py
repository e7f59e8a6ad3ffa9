"""Carry weights of the JAX package's models into the port.

``load_jax_params(module, flat)`` takes a JAX model's state flattened to
dotted paths and numpy arrays — its ``nnx.Param`` leaves plus the time
embedding's fixed Fourier projection (a plain ``nnx.Variable``) — and fills
the port's ``CFM`` (Video2Roll included), ``EncodecModel`` (encoder,
decoder and the quantizer's codebooks), ``CLIPVisionModel`` (ViT-bigG,
ViT-L/336), ``Dinov2Model``, ``ConvNextCLIP``, ``T5Encoder``,
``training.contrastive.FactorCL``, the evaluators' ``Cnn14`` or
``ClapModel``, and Audeo's ``Roll2MidiGenerator`` /
``Roll2MidiDiscriminator`` in place. The port mirrors the JAX module tree, so a path
maps to the module of the same path; only the leaf layout changes:

  * ``Linear`` kernel (in, out)                 -> weight (out, in)
  * ``nnx.Conv`` kernel (kh, kw, in, out)       -> weight (out, in, kh, kw)
    (``PatchEmbed``, ``Conv2d``; depthwise: in = 1)
  * ``CausalConv1d`` / depthwise kernel (k, in, out) -> weight (out, in, k)
  * ``CausalConvTranspose1d`` kernel (k, cout, cin)  -> weight (cin, cout, k)
  * ``LayerNorm`` scale -> weight, ``Embed`` embedding -> weight
  * ``nnx.BatchNorm`` scale / bias / mean / var
    -> weight / bias / running_mean / running_var
  * ``ResidualLSTM`` w_ih.i / w_hh.i / b_ih.i / b_hh.i -> lstm.*_l{i}

A key the port has no place for, any shape mismatch, and any port tensor
left unfilled raise. Fixed tables that the port rebuilds itself and does not
save (non-persistent buffers: CLAP's Swin ``rel_index`` and shifted-window
``attn_mask``, plain ``nnx.Variable``s in JAX) are not copied: a JAX value
given for one must equal the port's own, else it raises, and one left out
is not missing. Every parameter, the Swin ``bias_table`` included, must be
given.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from v2ap_torch.ops.layers import BatchNorm2d, Conv2d, Embed, LayerNorm, Linear

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_LSTM_LEAVES = {"w_ih": "weight_ih_l", "w_hh": "weight_hh_l",
                "b_ih": "bias_ih_l", "b_hh": "bias_hh_l"}


def _target(module: nn.Module, key: str):
    """(port tensor name, transform) for one JAX key."""
    from v2ap_torch.models.clip_vit import PatchEmbed
    from v2ap_torch.models.encodec import (
        CausalConv1d, CausalConvTranspose1d, ResidualLSTM)
    from v2ap_torch.ops.conv import DepthwiseConv1d

    parts = key.split(".")
    if len(parts) >= 3 and parts[-2] in _LSTM_LEAVES and parts[-1].isdigit():
        owner = ".".join(parts[:-2])
        if isinstance(module.get_submodule(owner), ResidualLSTM):
            return (f"{owner}.lstm.{_LSTM_LEAVES[parts[-2]]}{parts[-1]}",
                    lambda a: a)
    owner, leaf = ".".join(parts[:-1]), parts[-1]
    mod = module.get_submodule(owner) if owner else module
    prefix = f"{owner}." if owner else ""
    if isinstance(mod, Linear) and leaf == "kernel":
        return prefix + "weight", lambda a: a.T
    if isinstance(mod, (PatchEmbed, Conv2d)) and leaf == "kernel":
        return prefix + "weight", lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(mod, BatchNorm2d) and leaf in _BN_LEAVES:
        return prefix + _BN_LEAVES[leaf], lambda a: a
    if isinstance(mod, (CausalConv1d, CausalConvTranspose1d,
                        DepthwiseConv1d)) and leaf == "kernel":
        return prefix + "weight", lambda a: a.transpose(2, 1, 0)
    if isinstance(mod, LayerNorm) and leaf == "scale":
        return prefix + "weight", lambda a: a
    if isinstance(mod, Embed) and leaf == "embedding":
        return prefix + "weight", lambda a: a
    return prefix + leaf, lambda a: a


def copy_state(dst: torch.Tensor, sd: dict, key: str) -> None:
    """``sd[key]`` (a tensor or an array) into ``dst`` in place, in
    ``dst``'s dtype; a shape that does not fit raises. The state-dict
    readers of published checkpoints (PANN, CLAP) take their values so."""
    v = sd[key]
    v = torch.as_tensor(v.detach() if hasattr(v, "detach") else np.asarray(v))
    if tuple(v.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {tuple(v.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(v)


def _fixed_tables(module: nn.Module) -> set:
    """Dotted names of the non-persistent buffers under ``module``."""
    return {f"{prefix}.{name}" if prefix else name
            for prefix, mod in module.named_modules()
            for name in mod._non_persistent_buffers_set
            if getattr(mod, name, None) is not None}


def load_jax_params(module: nn.Module, flat: dict) -> None:
    """Copy ``flat`` (dotted JAX path -> array) into ``module`` in place."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    fixed = _fixed_tables(module)
    filled, unused = set(), []
    for key, arr in flat.items():
        try:
            name, transform = _target(module, key)
        except AttributeError:
            unused.append(key)
            continue
        if name not in tensors:
            unused.append(key)
            continue
        value = np.array(transform(np.asarray(arr)))      # writable copy
        dst = tensors[name]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {value.shape} does not fit "
                             f"{name} {tuple(dst.shape)}")
        if name in fixed:
            if not np.array_equal(value, dst.cpu().numpy()):
                raise ValueError(f"{key}: differs from the port's own fixed "
                                 f"table {name}")
            filled.add(name)
            continue
        with torch.no_grad():
            dst.copy_(torch.from_numpy(value))
        filled.add(name)
    if unused:
        raise KeyError(f"JAX keys with no place in the port: {sorted(unused)}")
    missing = sorted(set(tensors) - filled - fixed)
    if missing:
        raise KeyError(f"port tensors not filled: {missing}")
