"""The process mesh.

Counterpart of ``v2ap_tpu/parallel/mesh.py``: one 2-D
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, dims ``(data_axis, model_axis)``. ``data``: the batch's rows
split over the ranks, gradients summed over them; ``model``: Megatron
tensor parallelism (``v2ap_torch.parallel.sharding``). Ranks lie row-major
as JAX's ``reshape(dp, mp)`` lays devices out: rank r is data index
r // mp and model index r % mp, so the ranks of one model group are
consecutive (one host's cards under torchrun).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from v2ap_torch.config import MeshConfig
from v2ap_torch.parallel import distributed as pd


def make_mesh(cfg: MeshConfig | None = None,
              world_size: Optional[int] = None) -> DeviceMesh:
    """The (data, model) mesh over ``world_size`` ranks (the default
    group's). Needs ``init_distributed`` (or ``init_process_group``) first:
    a mesh is never built over a process group that does not exist."""
    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "v2ap_torch.parallel.distributed.init_distributed "
                           "first")
    n = world_size or dist.get_world_size()
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    assert dp * mp == n, f"mesh {dp}x{mp} != {n} devices"
    device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, mp),
                      mesh_dim_names=(cfg.data_axis, cfg.model_axis))


def mesh_axes(mesh: Optional[DeviceMesh]):
    """(data group, data size, data index, model group, model size, model
    index); groups None and sizes 1 without a mesh."""
    if mesh is None:
        return None, 1, 0, None, 1, 0
    out = []
    for dim in range(2):
        out += [mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)]
    return tuple(out)


@dataclass(frozen=True)
class RowSharding:
    """A tensor's placement over the data axis: each rank holds its
    contiguous block of rows of the global batch (``P("data")``), or the
    whole tensor (``replicated``). With ``micro`` > 1 micro-batches the
    global batch is ``micro`` blocks in a row, and each rank holds its
    block of each (the layout ``grad_accum`` splits)."""

    group: object
    size: int
    index: int
    split: bool = True

    def shard(self, t, micro: int = 1):
        """This rank's rows of ``t`` (a tensor or a numpy array)."""
        if not self.split or self.size == 1 or getattr(t, "ndim", 0) == 0:
            return t
        b = t.shape[0]
        if b % (micro * self.size):
            raise ValueError(f"{b} rows do not split into {micro} "
                             f"micro-batches over {self.size} ranks")
        per = b // (micro * self.size)
        t = t.reshape((micro, self.size, per) + tuple(t.shape[1:]))
        return t[:, self.index].reshape((micro * per,) + tuple(t.shape[3:]))

    def gather(self, t, micro: int = 1):
        """The inverse of ``shard``: every rank's rows, in order."""
        if not self.split or self.size == 1:
            return t
        g = pd.all_gather_cat(t.reshape((micro, -1) + tuple(t.shape[1:])),
                              self.group, dim=1)
        return g.reshape((-1,) + tuple(t.shape[1:]))


def batch_sharding(mesh: DeviceMesh) -> RowSharding:
    """Leading-axis (batch) sharding over the data axis."""
    group, size, index, *_ = mesh_axes(mesh)
    return RowSharding(group, size, index)


def replicated(mesh: DeviceMesh) -> RowSharding:
    group, size, index, *_ = mesh_axes(mesh)
    return RowSharding(group, size, index, split=False)
