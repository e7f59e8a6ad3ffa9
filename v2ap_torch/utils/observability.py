"""Spans and counters of the port's calls, and metrics logging.

Counterpart of ``v2ap_tpu/utils/observability.py``:

  * ``SpanRecorder`` — the port's span recorder (JAX's ``StageTimer``
    grown into one): named spans nested inside a call, each with its
    parent, the call's id and its host start and end, on CUDA also a pair
    of timing events on the current stream; counters of the call; each
    span also a ``torch.profiler.record_function`` range ``v2ap.<name>``,
    so a profiled run carries the spans beside the kernels;
  * ``MetricsLogger`` — JSONL metrics (always), TensorBoard scalars when
    ``torch.utils.tensorboard`` imports, latent "spectrogram" figures when
    matplotlib imports.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.profiler import record_function


@dataclass
class Span:
    name: str
    parent: Optional[int]          # index of the enclosing span in the call
    call_id: int
    host_start: float              # time.perf_counter()
    host_end: float = 0.0
    events: Optional[tuple] = None  # (start, end) CUDA events until resolved
    start: float = 0.0             # seconds from the call's first span start,
    end: float = 0.0               # on the card's clock on CUDA
    seconds: float = 0.0


@dataclass
class Call:
    id: int
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    stack: list = field(default_factory=list)
    resolved: bool = False


class SpanRecorder:
    """Spans and counters of one call at a time per thread.

    ``call()`` opens a call (or joins the one the thread has open, so an
    entry point called from another keeps one call); ``span(name)`` records
    a span of the open call, nested in the span open around it; ``count``
    adds to a counter of the open call. Outside a call a span is only its
    profiler range and a count is dropped.

    On a CUDA device each span records a start and an end event on the
    current stream, taken from a pool the resolved calls refill; its
    seconds are end minus start, the card's time for the span, waiting
    included. On the CPU the host clock gives them. Spans stay in memory
    until ``resolve`` reads the call (the last one to end by default),
    which waits for its last event: after a call whose result was copied
    to the host the stream has drained and that wait is empty."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.last: Optional[Call] = None
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._pool: list = []

    def _open(self) -> Optional[Call]:
        return getattr(self._local, "call", None)

    def _event(self):
        try:
            return self._pool.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    @contextlib.contextmanager
    def call(self):
        """The thread's open call, or a new one that becomes ``last`` when
        the block ends."""
        open_ = self._open()
        if open_ is not None:
            yield open_
            return
        c = self._local.call = Call(next(self._ids))
        try:
            yield c
        finally:
            self._local.call = None
            self.last = c

    @contextlib.contextmanager
    def span(self, name: str):
        c = self._open()
        with record_function("v2ap." + name):
            if c is None:
                yield
                return
            s = Span(name, c.stack[-1] if c.stack else None, c.id,
                     time.perf_counter())
            if self.cuda:
                s.events = (self._event(), self._event())
                s.events[0].record()
            c.spans.append(s)
            c.stack.append(len(c.spans) - 1)
            try:
                yield
            finally:
                c.stack.pop()
                if self.cuda:
                    s.events[1].record()
                s.host_end = time.perf_counter()

    def count(self, name: str, n: int = 1) -> None:
        c = self._open()
        if c is not None:
            c.counters[name] = c.counters.get(name, 0) + n

    def resolve(self, call: Optional[Call] = None) -> list:
        """The spans of ``call`` (default ``last``) with their times."""
        c = call or self.last
        if c is None:
            return []
        if not c.resolved and c.spans:
            if self.cuda:
                first = c.spans[0].events[0]
                max(c.spans, key=lambda s: s.host_end).events[1].synchronize()
                for s in c.spans:
                    s.start = first.elapsed_time(s.events[0]) / 1e3
                    s.end = first.elapsed_time(s.events[1]) / 1e3
                    self._pool.extend(s.events)
                    s.events = None
            else:
                t0 = c.spans[0].host_start
                for s in c.spans:
                    s.start, s.end = s.host_start - t0, s.host_end - t0
            for s in c.spans:
                s.seconds = s.end - s.start
        c.resolved = True
        return c.spans

    def totals(self, call: Optional[Call] = None) -> dict:
        """Seconds by span name, summed over the call's spans."""
        out: dict = {}
        for s in self.resolve(call):
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def log_spectrogram(self, step: int, name: str, latents) -> None:
        """Write ``latents`` (n, channels) as a figure ``<name>_<step>.png``
        (and to TensorBoard), when matplotlib imports."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import numpy as np
            if hasattr(latents, "detach"):
                latents = latents.detach().float().cpu().numpy()
            fig, ax = plt.subplots(figsize=(10, 3))
            ax.imshow(np.asarray(latents).T, aspect="auto", origin="lower")
            ax.set_title(f"{name} step {step}")
            path = os.path.join(self.log_dir, f"{name}_{step}.png")
            fig.savefig(path, dpi=80, bbox_inches="tight")
            if self._tb is not None:
                self._tb.add_figure(name, fig, step)
            plt.close(fig)
        except Exception:
            pass

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
