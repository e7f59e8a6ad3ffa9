"""Seeded weights for a configuration, made on the device in one draw.

The layout (every tensor's name and shape) is the plain reference's; the
served modules load the same tensors by the same names, strictly, so a
layout that differs from the served one fails at set-up. One
``torch.randn`` over all tensors, in bfloat16 (the type the frozen towers
are served in; the flow model's float32 parameters then hold bf16 values),
is sliced into views and scaled in place:

* a tensor of two or more dimensions: normal with variance 1 / fan-in
  (fan-in = numel / rows), the scale of the modules' own initialisers;
  zero-initialised projections (the stream fusions, AdaLN gates) get this
  scale too, so that every stream and the prompt reach the output;
* a bias, or a batch norm's running mean: normal with std 0.02;
* any other vector (norm gains, layer scales, running variances, the
  Fourier frequencies): 1 + 0.1 normal;
* T5's query projections: variance 1 / (d_model d_kv), T5's own
  initialiser scale. T5's attention is unscaled; at 1 / d_model its
  logits (std ~8) make the softmax all but one-hot, and the bf16 and
  float32 encoders then differ by ~60 % (1.5 % at T5's scale).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.cfm import CFM
from benchmark.reference.encodec import EncodecDecoder
from benchmark.reference.t5 import T5Encoder
from benchmark.reference.towers import TOWERS


def layout(cfg: dict, with_t5: bool) -> dict:
    """component -> {name: shape}: "cfm", "decoder", "t5" (if ``with_t5``),
    and "towers" -> tower name -> {name: shape}."""
    def shapes(module):
        return {k: tuple(v.shape) for k, v in module.state_dict().items()}

    out = {"cfm": shapes(CFM(cfg["model"], cfg["conditioning"],
                             device="meta")),
           "decoder": shapes(EncodecDecoder(cfg["encodec"], device="meta"))}
    if with_t5:
        out["t5"] = shapes(T5Encoder(cfg["t5"], device="meta"))
    mode = cfg["conditioning"]["video_encoder"]
    names = list(TOWERS) if mode == "mixed" else [mode]
    out["towers"] = {n: shapes(TOWERS[n][0](cfg["towers"][n], device="meta"))
                     for n in names}
    return out


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _scale_(name: str, t: torch.Tensor, fan_extra: int = 1) -> None:
    leaf = name.rsplit(".", 1)[-1]
    if t.dim() >= 2:
        t.mul_(1.0 / math.sqrt(t.numel() // t.shape[0] * fan_extra))
    elif leaf.startswith("bias") or leaf == "running_mean":
        t.mul_(0.02)
    else:
        t.mul_(0.1).add_(1.0)


@torch.no_grad()
def make(cfg: dict, seed: int, device, with_t5: bool) -> dict:
    """The weights of ``layout(cfg, with_t5)`` drawn from ``seed``: the same
    seed gives the same tensors."""
    tree = layout(cfg, with_t5)
    leaves = list(_leaves(tree))
    total = sum(math.prod(shape) for _, shape in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.bfloat16,
                       device=device)
    out: dict = {}
    offset = 0
    for path, shape in leaves:
        n = math.prod(shape)
        t = flat[offset: offset + n].view(shape)
        offset += n
        t5_query = path[0] == "t5" and path[-1].endswith("attn.q.weight")
        _scale_(path[-1], t, cfg["t5"]["d_kv"] if t5_query else 1)
        node = out
        for key in path[:-2]:
            node = node.setdefault(key, {})
        node.setdefault(path[-2], {})[path[-1]] = t
    return out
