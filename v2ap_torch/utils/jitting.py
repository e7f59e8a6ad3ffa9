"""Model construction helpers and the captured sampler program.

Counterpart of ``v2ap_tpu/utils/jitting.py``:

  * ``cast_params`` stores the compute-dtype copies of weights that every
    call would cast anyway (the serving CFM, once, at pipeline build);
  * ``model_rngs`` is the seeded ``torch.Generator`` a model's random
    stream draws from;
  * ``create_model_zeros`` builds a model's structure on the meta device
    and materialises zeros, for weight-loading flows;
  * ``machine_fingerprint`` names this host's CPU capabilities;
  * ``CapturedPrograms`` is the counterpart of ``nnx.jit`` with static
    arguments: one CUDA graph per key, replayed with new inputs copied into
    its static buffers, as JAX compiles one XLA program per shape bucket
    and static value; ``batch_bucket`` and ``pad_batch`` round a batch up
    to a power of two, which bounds the keys a server makes.

``enable_compile_cache`` and ``force_cpu_if_requested`` are JAX-only and
have no counterpart: PyTorch's eager operations compile nothing that a
cache would keep, and the port's entry points take ``device="cpu"``.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import platform
import threading
import time
from typing import Callable, Hashable, NamedTuple, Optional, Sequence

import torch
from torch import nn

from v2ap_torch.ops.conv import DepthwiseConv1d
from v2ap_torch.ops.flash_attention import add_launches, recording_launches
from v2ap_torch.ops.layers import Conv2d, Embed, Linear

log = logging.getLogger(__name__)

# modules whose forward casts ``weight`` and ``bias`` to ``self.dtype`` on
# every call, and nothing else reads them in another dtype
_CAST_EVERY_CALL = (Linear, Embed, Conv2d, DepthwiseConv1d)
# captured programs kept, the least recently used going first: the server's
# batches at one duration bucket make 4 batch buckets (1, 2, 4, 8) under the
# 25-step sampler and 4 under the few-step one
MAX_PROGRAMS = 8


def machine_fingerprint() -> str:
    """Short stable id for this host's CPU: its architecture and the sorted
    CPU flags (``/proc/cpuinfo``), hashed."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha256((platform.machine() + flags).encode()
                          ).hexdigest()[:12]


def model_rngs(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the CPU when None) seeded with
    ``seed``: the explicit random stream a caller hands to what draws."""
    return torch.Generator(device=device or "cpu").manual_seed(seed)


def create_model_zeros(factory: Callable[[torch.device], nn.Module],
                       device=None) -> nn.Module:
    """Structure-only construction: ``factory(torch.device("meta"))`` builds
    the model without initialising anything, then every parameter and
    buffer is materialised on ``device`` (the CPU when None) as zeros. For
    flows that overwrite every tensor (weight loading, shape audits): do
    not run a model built this way before loading weights."""
    model = factory(torch.device("meta"))
    model.to_empty(device=device or "cpu")
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.zero_()
    return model


def cast_params(module: nn.Module, dtype: torch.dtype) -> int:
    """Store in ``dtype`` the weight and bias of every ``Linear``, ``Embed``,
    ``Conv2d`` and ``DepthwiseConv1d`` under ``module`` whose compute dtype
    is ``dtype``. Each of these casts both to its compute dtype on every
    call, so the stored copy changes no result: it removes the casts. Norms,
    the time embedding and every layer computing in another dtype keep
    their float32 parameters (JAX's ``cast_params`` casts every float
    parameter, which would change the port's result). Returns the number of
    tensors cast."""
    n = 0
    for m in module.modules():
        if not isinstance(m, _CAST_EVERY_CALL) or m.dtype != dtype:
            continue
        for p in (m.weight, getattr(m, "bias", None)):
            if p is not None and p.dtype != dtype:
                p.data = p.data.to(dtype)
                n += 1
    return n


def _release_generator(dev: torch.device) -> None:
    """A failed capture leaves the device's default generator marked as
    capturing (PyTorch ends its capture only when the graph ends cleanly),
    and every later random draw on the device then raises. Give it a fresh
    state at the same seed and offset."""
    gen = torch.cuda.default_generators[
        dev.index if dev.index is not None else torch.cuda.current_device()]
    fresh = torch.Generator(device=dev)
    fresh.set_state(gen.get_state())
    gen.graphsafe_set_state(fresh.graphsafe_get_state())


def batch_bucket(b: int) -> int:
    """The batch a program is captured for: ``b`` rounded up to a power of
    two, so that a server's batches of 1 to ``max_batch`` clips make
    log2(max_batch) + 1 programs per duration bucket and sampler, not
    ``max_batch``."""
    return 1 << max(0, b - 1).bit_length()


def pad_batch(t: Optional[torch.Tensor], size: int, dim: int = 0
              ) -> Optional[torch.Tensor]:
    """``t`` with its last row along ``dim`` repeated up to ``size`` rows (a
    valid input row, unlike zeros under an all-false mask)."""
    if t is None or t.shape[dim] == size:
        return t
    last = t.narrow(dim, t.shape[dim] - 1, 1)
    shape = list(t.shape)
    shape[dim] = size - t.shape[dim]
    return torch.cat([t, last.expand(shape)], dim)


class Capture(NamedTuple):
    key: Hashable
    seconds: float                 # warm-up and capture
    warmup_s: float                # the eager warm-up on the side stream
    pool_bytes: int                # the program's memory pool (and output)


class _Program(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple                  # static input buffers, None kept as None
    output: torch.Tensor           # the graph's output buffer
    launches: collections.Counter  # the kernels' wrappers' launches a replay


class CapturedPrograms:
    """CUDA graphs by key, the least recently used evicted past
    ``MAX_PROGRAMS``.

    ``run(key, fn, inputs)`` captures ``fn(*static_inputs)`` the first time
    it sees ``key``: it copies ``inputs`` into static buffers, runs
    ``warmup`` (default ``fn``) once eagerly on a side stream, as
    ``torch.cuda.graph`` requires, then captures ``fn`` on its own memory
    pool. Every call copies ``inputs`` into the key's buffers, replays the
    graph and returns a copy of its output. ``fn`` must run the same work
    for every input of the key (shapes and Python values in the key) and
    may not synchronise with the host; a capture that fails raises, and
    nothing falls back to running eagerly.

    A program reads every tensor it was captured with at its address: the
    static inputs (kept here), its intermediates (its own pool) and the
    model's parameters, whose storage must therefore not be replaced
    afterwards (an in-place ``copy_`` is fine). Calls from several threads
    (the HTTP server's) are serialised by a lock, so that one call's
    inputs cannot overwrite another's buffers before its replay; the
    capture restricts only its own thread
    (``capture_error_mode="thread_local"``).

    A replay calls none of the kernels' wrappers: the launches they
    recorded into the graph while it was captured
    (``ops.flash_attention.recording_launches``) are added to their
    counters at every replay, and the eager warm-up counts as it runs.
    ``captures`` lists a ``Capture`` for every capture; its pool is what
    the card's reserved memory grew by while ``fn`` was captured
    (``torch.cuda.graph`` empties the cache first, so the growth is the
    program's own pool).
    """

    def __init__(self):
        self.captures: list = []
        self._programs: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._programs)

    def run(self, key: Hashable, fn: Callable[..., torch.Tensor],
            inputs: Sequence[Optional[torch.Tensor]],
            warmup: Optional[Callable[..., object]] = None) -> torch.Tensor:
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = self._capture(key, fn, inputs, warmup)
            else:
                self._programs.move_to_end(key)
                for buf, x in zip(prog.inputs, inputs):
                    if buf is not None:
                        buf.copy_(x)
            prog.graph.replay()
            add_launches(prog.launches)
            return prog.output.clone()

    def _capture(self, key, fn, inputs, warmup) -> _Program:
        static = tuple(None if x is None else x.clone() for x in inputs)
        dev = next(x.device for x in static if x is not None)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            (warmup or fn)(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        warmup_s = time.perf_counter() - t0
        graph = torch.cuda.CUDAGraph()
        try:
            with recording_launches() as launches, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(dev)
                out = fn(*static)
                pool = torch.cuda.memory_reserved(dev) - reserved
        except Exception as exc:
            _release_generator(dev)
            raise RuntimeError(f"capturing the program for {key} failed; "
                               f"it does not run eagerly instead") from exc
        self._programs[key] = prog = _Program(graph, static, out, launches)
        while len(self._programs) > MAX_PROGRAMS:
            self._programs.popitem(last=False)
        c = Capture(key, time.perf_counter() - t0, warmup_s, pool)
        self.captures.append(c)
        log.info("captured the program for %s in %.3f s (warm-up %.3f s, "
                 "pool %.1f MiB)", key, c.seconds, warmup_s, pool / 2**20)
        return prog
