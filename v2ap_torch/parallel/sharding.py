"""Tensor-parallel sharding rules and the sharded modules' arithmetic.

Counterpart of ``v2ap_tpu/parallel/sharding.py``. The placement rules are
JAX's: a matrix whose module name ends in one of ``_COL_SUFFIXES`` splits
its output features over the mesh's ``model`` axis, one ending in
``_ROW_SUFFIXES`` its input features, when they divide; everything else is
replicated. A torch ``Linear`` stores its weight (out, in), so "column" is
dim 0 and "row" dim 1 of ``weight`` (``param_spec``).

JAX's rules are placement annotations that GSPMD keeps exact whatever it
splits. Here the split is literal (Megatron), so ``shard_model`` makes each
sharded module compute what the whole one computes:

  * attention (the CFM's ``Attention``, CLIP's and T5's) runs its own
    ``heads // mp`` heads: the fused ``to_qkv`` splits q, k and v each by
    heads, the per-head value gates (``to_v_gates``, replicated as in JAX)
    take this rank's heads' rows, T5's relative bias its heads, and the
    output projection is row-parallel;
  * the GLU feed-forward splits the value and gate halves of ``proj_in``
    each, CLIP's MLP ``fc1``, T5's gated ``wi_0`` / ``wi_1``;
  * a row-parallel product sums its float32 partial outputs over the
    model group and adds its bias once, after the sum;
  * any other matrix the rules split gathers a column-parallel output
    back to full width, and a row-parallel one takes its block of a
    replicated input (the CFM's ``proj_in``, Video2Roll's ``fc1`` /
    ``fc2``, T5's ``wo`` after the non-gated ``wi``).

Column-parallel products run as ``distributed.column_product`` (the
input's gradient summed over the model group in float32), row-parallel
ones as ``row_partial`` then ``reduce_from_group``. A replicated parameter that a rank uses only
in part (the value gates' rows, a column layer's bias) is tagged
``_tp_partial``: its gradient is summed over the model group before the
optimizer step (``v2ap_torch.training.trainer``). Dropout masks are drawn
at the global shape from the model's generator, and each rank takes its
rows (data axis) and columns (model axis), so a sharded step equals the
unsharded one at any rate. Each split weight carries its ``Layout``
(``parallel.state``) as ``_tp_layout``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2ap_torch.models.clip_vit import CLIPAttention, CLIPMLP
from v2ap_torch.models.t5 import T5Attention, T5FF
from v2ap_torch.ops.attention import Attention
from v2ap_torch.ops.feedforward import GLUFeedForward
from v2ap_torch.ops.layers import Dropout, Linear
from v2ap_torch.parallel import distributed as pd
from v2ap_torch.parallel.mesh import mesh_axes
from v2ap_torch.parallel.state import Layout

# module-name suffixes sharded column-wise (output features over 'model')
_COL_SUFFIXES = (
    ("to_q", "weight"), ("to_k", "weight"), ("to_v", "weight"),
    ("to_qkv", "weight"),
    ("proj_in", "weight"),          # GLU FF input projection
    ("wi_0", "weight"), ("wi_1", "weight"),  # T5 FF
    ("q", "weight"), ("k", "weight"), ("v", "weight"),
    ("fc1", "weight"),
)
# row-wise (input features split; the partial outputs are summed)
_ROW_SUFFIXES = (
    ("to_out", "weight"), ("proj_out", "weight"), ("wo", "weight"),
    ("o", "weight"), ("fc2", "weight"),
)


def param_spec(name: str, tensor: torch.Tensor,
               model_size: int) -> Optional[int]:
    """The dim of ``tensor`` (the parameter ``name`` of the port) that JAX's
    rules split over a model axis of ``model_size``, or None
    (replicated)."""
    names = tuple(name.split("."))
    if model_size <= 1 or tensor.ndim < 2:
        return None
    for suf in _COL_SUFFIXES:
        if names[-len(suf):] == suf and tensor.shape[0] % model_size == 0:
            return 0
    for suf in _ROW_SUFFIXES:
        if names[-len(suf):] == suf and tensor.shape[1] % model_size == 0:
            return 1
    return None


class TPLinear:
    """A ``Linear``'s tensor-parallel product (``Linear.tp``). ``mode``:
    "col" (local output features), "col_gather" (gathered back to full
    width), "row" (local input features, summed output), "row_slice"
    (this rank's block of a replicated input, then "row")."""

    def __init__(self, mode: str, layout: Layout):
        self.mode, self.layout = mode, layout

    def __call__(self, lin: Linear, x: torch.Tensor) -> torch.Tensor:
        dt, lay = lin.dtype, self.layout
        w, b = lin.weight.to(dt), lin.bias
        if self.mode == "col":
            b = None if b is None else lay.shard(b).to(dt)
            return pd.column_product(x.to(dt), w, b, lay.group)
        if self.mode == "col_gather":
            y = pd.column_product(x.to(dt), w, None, lay.group)
            y = pd.gather_from_group(y, lay.group, -1)
            return y if b is None else y + b.to(dt)
        if self.mode == "row_slice":
            x = pd.scatter_to_group(x, lay.group, -1)
        y = pd.reduce_from_group(pd.row_partial(x.to(dt), w), lay.group)
        if b is not None:
            y = y + b.float()
        return y.to(dt)


def _set(lin: Linear, mode: str, groups: int, group, size: int,
         rank: int) -> None:
    if lin.int8:
        raise NotImplementedError("tensor parallelism over int8 products: "
                                  "shard the bf16 model")
    dim = 0 if mode.startswith("col") else 1
    lay = Layout(dim, groups, group, size, rank)
    w = nn.Parameter(lay.shard(lin.weight.detach()).clone(),
                     requires_grad=lin.weight.requires_grad)
    w._tp_layout = lay
    lin.weight = w
    if lin.bias is not None and mode == "col":
        lin.bias._tp_partial = True
    lin.tp = TPLinear(mode, lay)


def _specs(model_size: int, *lins) -> tuple:
    return tuple(param_spec(name, lin.weight, model_size)
                 for name, lin in lins)


def shard_model(model: nn.Module, mesh) -> None:
    """Split every parameter of ``model`` over the mesh's model axis by the
    rules (in place; nothing with ``model_parallel`` 1), and set every
    dropout to draw the global batch's mask and take this data rank's
    rows."""
    _, dsize, didx, group, size, rank = mesh_axes(mesh)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rows = (dsize, didx)
    model._tp_mesh = mesh
    if size == 1:
        return
    named = dict(model.named_modules())
    name_of = {id(m): n for n, m in named.items()}
    done = set()

    def full(lin):
        n = name_of[id(lin)]
        return (n + "." if n else "") + "weight", lin

    def place(lin, mode, groups=1):
        _set(lin, mode, groups, group, size, rank)
        done.add(id(lin))

    for m in list(named.values()):
        if isinstance(m, Attention):
            cols = ([m.to_qkv] if m.fused_qkv else [m.to_q, m.to_k, m.to_v])
            specs = _specs(size, *map(full, cols + [m.to_out]))
            if m.heads % size or specs != (0,) * len(cols) + (1,):
                continue
            for lin in cols:
                place(lin, "col", 3 if m.fused_qkv else 1)
            place(m.to_out, "row")
            m.heads //= size
            m.tp = (group, rank * m.heads)
            if m.to_v_gates is not None:
                m.to_v_gates.weight._tp_partial = True
                if m.to_v_gates.bias is not None:
                    m.to_v_gates.bias._tp_partial = True
                done.add(id(m.to_v_gates))
            m.dropout.cols = (size, rank)
        elif isinstance(m, GLUFeedForward):
            inner = m.proj_out.weight.shape[1]
            if inner % size or _specs(size, full(m.proj_in),
                                      full(m.proj_out)) != (0, 1):
                continue
            place(m.proj_in, "col", 2)
            place(m.proj_out, "row")
            m.dropout.cols = (size, rank)
        elif isinstance(m, (CLIPAttention, T5Attention)):
            if m.heads % size or _specs(
                    size, *map(full, (m.q, m.k, m.v, m.o))) != (0, 0, 0, 1):
                continue
            for lin in (m.q, m.k, m.v):
                place(lin, "col")
            place(m.o, "row")
            m.heads //= size
            m.head0 = rank * m.heads
        elif isinstance(m, CLIPMLP) or (isinstance(m, T5FF) and m.gated):
            cols = [m.fc1] if isinstance(m, CLIPMLP) else [m.wi_0, m.wi_1]
            row = m.fc2 if isinstance(m, CLIPMLP) else m.wo
            if _specs(size, *map(full, cols + [row])) != \
                    (0,) * len(cols) + (1,):
                continue
            for lin in cols:
                place(lin, "col")
            place(row, "row")
    # every other matrix the rules split: gathered / sliced in place
    for m in list(named.values()):
        if isinstance(m, Linear) and id(m) not in done:
            spec = param_spec(full(m)[0], m.weight, size)
            if spec is not None:
                place(m, "col_gather" if spec == 0 else "row_slice")


def state_shardings(model: nn.Module, mesh=None) -> dict:
    """Each parameter's placement over the model axis, by name: a DTensor
    ``Shard(dim)`` for a split one, ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate, Shard

    return {name: (Shard(p._tp_layout.dim) if hasattr(p, "_tp_layout")
                   else Replicate())
            for name, p in model.named_parameters()}
