"""Process groups, the collectives the port's parallelism runs, and
cross-rank metric reduction.

Counterpart of ``v2ap_tpu/parallel/distributed.py``. Call
``init_distributed()`` once per process before building a mesh: under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or with explicit arguments it forms the default process
group, NCCL on CUDA and gloo on the CPU; in a single process it returns
False, so entry points call it unconditionally. Under torchrun the world
size is ``WORLD_SIZE``. ``V2AP_NUM_HOSTS`` keeps its JAX meaning, the
number of hosts: without torchrun's variables it is the gate (1 or unset
means a single process; more means one process per host, as JAX runs
one), and under torchrun it must agree with ``WORLD_SIZE`` /
``LOCAL_WORLD_SIZE`` or the call raises. A rendezvous that fails or times
out raises; it never carries on as one process.

The collectives below skip a group of one rank (nothing to exchange), so a
mesh of size 1 in an axis adds no operation. ``all_gather`` runs on gloo
over CUDA tensors as a sum of zero-padded blocks (gloo's CUDA path carries
all-reduce but not all-gather). The autograd functions are Megatron's
f / g pair and their gather / scatter duals: ``column_product`` (this
rank's output features of a product with a replicated input; the input's
gradient summed over the group), ``reduce_from_group`` (sum, gradient
passed through), ``gather_from_group`` (concatenate the ranks' blocks,
gradient sliced back) and ``scatter_to_group`` (take this rank's block,
gradient gathered). Partial products that the group sums
(``row_partial`` forward, ``column_product``'s input gradient) are kept
in float32 until the sum: bf16 operands on the tensor cores with the
float32 accumulator returned unrounded, so the sum is rounded once, as
the unsharded product is.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

DEFAULT_TIMEOUT_S = 600


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    """An ``init_method`` URL from an explicit address ("host:port", or a
    ``tcp://`` / ``file://`` URL) or torchrun's MASTER_ADDR / MASTER_PORT."""
    if coordinator_address:
        if "://" in coordinator_address:
            return coordinator_address
        return f"tcp://{coordinator_address}"
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        return (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ['MASTER_PORT']}")
    return None


def _world_size(num_processes: Optional[int]) -> int:
    """The number of processes: torchrun's ``WORLD_SIZE`` when it is set
    (``num_processes`` and ``V2AP_NUM_HOSTS`` must agree with it), else
    ``num_processes``, else ``V2AP_NUM_HOSTS`` (one process per host)."""
    hosts = os.environ.get("V2AP_NUM_HOSTS")
    hosts = int(hosts) if hosts else None
    if "WORLD_SIZE" not in os.environ:
        return int(num_processes or hosts or 1)
    world = int(os.environ["WORLD_SIZE"])
    if num_processes is not None and num_processes != world:
        raise RuntimeError(f"num_processes={num_processes} but torchrun's "
                           f"WORLD_SIZE={world}")
    if hosts is not None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
        if (hosts < 1 or world % hosts
                or (local and world // local != hosts)):
            raise RuntimeError(
                f"V2AP_NUM_HOSTS={hosts} contradicts torchrun's "
                f"WORLD_SIZE={world} (LOCAL_WORLD_SIZE="
                f"{local or 'unset'}): it counts hosts, not processes")
    return world


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the default process group when running several processes;
    return False (and do nothing) in a single one. ``device`` None means
    CUDA (the NCCL backend; raises without a card), ``"cpu"`` gloo;
    ``backend`` overrides the choice (gloo over CUDA tensors, for ranks that
    share one card). On CUDA the process's device becomes
    ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    world = _world_size(num_processes)
    if world <= 1:
        return False
    if process_id is None:
        if "RANK" not in os.environ:
            raise RuntimeError(f"{world} processes but no rank: pass "
                               f"process_id or run under torchrun")
        process_id = int(os.environ["RANK"])
    url = _address(coordinator_address)
    if url is None:
        raise RuntimeError(f"{world} processes but no coordinator: pass "
                           f"coordinator_address or set MASTER_ADDR / "
                           f"MASTER_PORT")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for "
                               "gloo process groups on the CPU")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=url, world_size=world, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def host_shard_info() -> Tuple[int, int]:
    """(rank, world_size) for per-rank input pipelines (the batcher's
    striding); (0, 1) in a single process."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _device_of(group) -> torch.device:
    """Where a collective's tensors must lie for the group's backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_hosts_mean(value: float, mesh=None) -> float:
    """The mean of a rank-local Python scalar over every rank (one
    one-element all-reduce); the value itself in a single process."""
    if _size(None) == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_device_of(None))
    dist.all_reduce(t)
    return float(t.item()) / dist.get_world_size()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor; ``t`` itself for a
    group of one)."""
    if _size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in group
    rank order."""
    n = _size(group)
    if n == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "nccl":
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
    elif t.is_cuda:
        # gloo's CUDA path has all-reduce only: a sum of zero-padded blocks
        # (x + 0 is x exactly)
        out = t.new_zeros((n,) + tuple(t.shape))
        out[_rank(group)] = t
        dist.all_reduce(out, group=group)
        out = out.flatten(0, 1)
    else:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts)
    return out.movedim(0, dim)


def block(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim``."""
    n = _size(group)
    if n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{n} ranks")
    return t.narrow(dim, _rank(group) * (size // n), size // n)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.group, ctx.dim), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient passes through (the output of a
    row-parallel product, a partial loss sum)."""
    if _size(group) == 1:
        return x
    if not torch.is_grad_enabled():
        return all_reduce_sum(x, group)
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``; each rank's gradient
    is its block of the output's."""
    if _size(group) == 1:
        return x
    if not torch.is_grad_enabled():
        return all_gather_cat(x, group, dim)
    return _GatherFromGroup.apply(x, group, dim)


def scatter_to_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of a replicated tensor; the gradient
    is gathered back to the full width."""
    if _size(group) == 1:
        return x
    dim = dim % x.ndim
    if not torch.is_grad_enabled():
        return block(x, group, dim)
    return _ScatterToGroup.apply(x, group, dim)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` with a float32 result: on CUDA in bf16 / f16 the
    tensor cores' float32 accumulator unrounded (``out_dtype``); elsewhere
    the product of the upcast operands (exact products, float32 sums)."""
    if a.dtype == torch.float32:
        return F.linear(a, b)
    if a.is_cuda:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b.t(),
                     out_dtype=torch.float32)
        return y.view(*a.shape[:-1], b.shape[0])
    return F.linear(a.float(), b.float())


def _weight_grad(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])


class _RowPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w if ctx.needs_input_grad[0] else None,
                _weight_grad(g, x) if ctx.needs_input_grad[1] else None)


class _ColumnProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.has_bias = group, b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = all_reduce_sum(_mm_f32(g, w.t()), ctx.group).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = _weight_grad(g, x)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.reshape(-1, g.shape[-1]).sum(0)
        return gx, gw, gb, None


def row_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """This rank's float32 partial of a row-parallel product, ``x @ w.T``
    over its input features (the caller sums it with
    ``reduce_from_group``); the gradients are the unsharded product's own
    blocks, in ``x``'s dtype."""
    if not torch.is_grad_enabled():
        return _mm_f32(x, w)
    return _RowPartial.apply(x, w)


def column_product(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], group) -> torch.Tensor:
    """``F.linear(x, w, b)`` for this rank's output features ``w`` of a
    product whose input ``x`` is replicated over ``group``: the input's
    gradient is the ranks' partial products summed in float32, rounded
    once to ``x``'s dtype."""
    if _size(group) == 1 or not torch.is_grad_enabled():
        return F.linear(x, w, b)
    return _ColumnProduct.apply(x, w, b, group)
