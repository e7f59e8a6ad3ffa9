"""A sharded model's state, over the process groups alone.

Each parameter that ``parallel.sharding.shard_model`` splits carries its
``Layout`` as ``_tp_layout``; nothing here reads a model's classes.
``gather_like`` / ``shard_like`` move a tensor laid out as a parameter
(the parameter itself, an optimizer moment, an EMA shadow) between this
rank's part and the unsharded tensor; ``full_state_dict`` gathers a
model's state back to the unsharded one (checkpoints, written by rank 0),
``load_full_state_dict`` shards one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from v2ap_torch.parallel import distributed as pd


@dataclass(frozen=True)
class Layout:
    """How a parameter is split: along ``dim``, each of its ``groups``
    equal chunks (q / k / v, value / gate) split over the ``size`` ranks of
    ``group``; this rank holds block ``rank`` of each chunk."""

    dim: int
    groups: int
    group: object
    size: int
    rank: int

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        return torch.cat([c.chunk(self.size, self.dim)[self.rank]
                          for c in full.chunk(self.groups, self.dim)],
                         self.dim)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return torch.cat([pd.all_gather_cat(c.contiguous(), self.group,
                                            self.dim)
                          for c in local.chunk(self.groups, self.dim)],
                         self.dim)


def gather_like(param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` laid out as ``param`` (its shard, or a tensor of its shape such
    as an optimizer moment), gathered to the unsharded shape."""
    lay = getattr(param, "_tp_layout", None)
    return t if lay is None else lay.gather(t)


def shard_like(param: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """The inverse of ``gather_like``: this rank's part of ``full``."""
    lay = getattr(param, "_tp_layout", None)
    return full if lay is None else lay.shard(full)


def is_sharded(model: nn.Module) -> bool:
    return any(hasattr(p, "_tp_layout") for p in model.parameters())


@torch.no_grad()
def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every shard gathered to its unsharded
    tensor (a collective: every rank of the model group calls it)."""
    params = dict(model.named_parameters())
    return {k: (gather_like(params[k], v) if k in params else v)
            for k, v in model.state_dict().items()}


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Load an unsharded state (``full_state_dict``'s, or one written in a
    single process) into a sharded ``model``."""
    params = dict(model.named_parameters())
    model.load_state_dict({k: (shard_like(params[k], v) if k in params
                               else v) for k, v in state.items()})
