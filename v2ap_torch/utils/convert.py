"""Carry weights of the JAX package's models into the port.

``load_jax_params(module, flat)`` takes a JAX model's state flattened to
dotted paths and numpy arrays — its ``nnx.Param`` leaves plus the time
embedding's fixed Fourier projection (a plain ``nnx.Variable``) — and fills
the port's ``CFM``, ``EncodecModel`` or ``CLIPVisionModel`` in place. The
port mirrors the JAX module tree, so a path maps to the module of the same
path; only the leaf layout changes:

  * ``Linear`` kernel (in, out)                 -> weight (out, in)
  * ``nnx.Conv`` kernel (kh, kw, in, out)       -> weight (out, in, kh, kw)
  * ``CausalConv1d`` / depthwise kernel (k, in, out) -> weight (out, in, k)
  * ``CausalConvTranspose1d`` kernel (k, cout, cin)  -> weight (cin, cout, k)
  * ``LayerNorm`` scale -> weight, ``Embed`` embedding -> weight
  * ``ResidualLSTM`` w_ih.i / w_hh.i / b_ih.i / b_hh.i -> lstm.*_l{i}

Keys of modules the port does not build yet (Video2Roll, the EnCodec
encoder and quantizer) are skipped and named in a warning. Any other key
the port has no place for, any shape mismatch, and any port tensor left
unfilled raise.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from v2ap_torch.ops.layers import Embed, LayerNorm, Linear

# prefixes of JAX modules that later slices of the port will build
_NOT_PORTED = ("video2roll.", "encoder.", "quantizer.")
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
    if isinstance(mod, PatchEmbed) and leaf == "kernel":
        return prefix + "weight", lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(mod, (CausalConv1d, CausalConvTranspose1d,
                        DepthwiseConv1d)) and leaf == "kernel":
        return prefix + "weight", lambda a: a.transpose(2, 1, 0)
    if isinstance(mod, LayerNorm) and leaf == "scale":
        return prefix + "weight", lambda a: a
    if isinstance(mod, Embed) and leaf == "embedding":
        return prefix + "weight", lambda a: a
    return prefix + leaf, lambda a: a


def load_jax_params(module: nn.Module, flat: dict) -> list:
    """Copy ``flat`` (dotted JAX path -> array) into ``module`` in place.
    Returns the skipped keys of not-yet-ported modules."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    filled, skipped, unused = set(), [], []
    for key, arr in flat.items():
        if key.startswith(_NOT_PORTED):
            skipped.append(key)
            continue
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
        with torch.no_grad():
            dst.copy_(torch.from_numpy(value))
        filled.add(name)
    if unused:
        raise KeyError(f"JAX keys with no place in the port: {sorted(unused)}")
    missing = sorted(set(tensors) - filled)
    if missing:
        raise KeyError(f"port tensors not filled: {missing}")
    if skipped:
        warnings.warn(f"skipped {len(skipped)} keys of modules the port does "
                      f"not build yet: {sorted(skipped)}")
    return skipped
