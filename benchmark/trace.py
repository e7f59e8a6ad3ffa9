"""The device trace of a traced segment: ``torch.profiler`` (CPU and CUDA
activities) around a few whole requests, exported as a Chrome trace to
``TMPDIR`` and read back, then deleted.

``Trace`` holds every device operation (kernels, copies, fills) as (name,
start, duration) in microseconds, the host operations (name, start, end),
and the segment's wall seconds. Busy time is the union of the device
operations' intervals; idle gaps are the holes in that union, each named
by the innermost host operation running at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

from benchmark.stats import union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device_ops = [(e["name"], float(e["ts"]), float(e["dur"]))
                           for e in events if e.get("cat") in DEVICE_CATS
                           and "dur" in e]
        self.host_ops = [(e["name"], float(e["ts"]),
                          float(e["ts"]) + float(e["dur"]))
                         for e in events if e.get("cat") in HOST_CATS
                         and "dur" in e]

    def kernels(self, *fragments: str) -> list:
        """(name, start_us, dur_us) of the kernels whose name holds any of
        ``fragments``."""
        return [k for k in self.device_ops
                if any(f in k[0] for f in fragments)]

    def busy_s(self) -> float:
        return union_seconds((s, s + d) for _, s, d in self.device_ops) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by_name = defaultdict(float)
        for name, _, dur in self.device_ops:
            by_name[name[:120]] += dur / 1e6
        return sorted(([n, s] for n, s in by_name.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest holes between device operations, as [host
        operation running at the hole's middle, seconds]."""
        spans = sorted((s, s + d) for _, s, d in self.device_ops)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:k]:
            mid = (a + b) / 2
            covering = [(e - s, name) for name, s, e in self.host_ops
                        if s <= mid <= e]
            if covering:
                label = min(covering)[1]
            else:               # between host operations: the one before
                before = [(e, name) for name, s, e in self.host_ops
                          if e <= mid]
                label = ("after " + max(before)[1] if before
                         else "no host operation")
            out.append([label[:120], length / 1e6])
        return out


@contextlib.contextmanager
def traced(sync):
    """Profile the ``with`` body; ``sync()`` waits for the device before
    the clock stops. Yields a list that holds the ``Trace`` afterwards."""
    from torch.profiler import ProfilerActivity, profile

    holder = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield holder
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder.append(Trace(events, window_s))
