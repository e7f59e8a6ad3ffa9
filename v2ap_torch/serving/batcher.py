"""Continuous micro-batching for serving.

Counterpart of ``v2ap_tpu/serving/batcher.py``. N simultaneous requests
batched into ONE ``V2APipeline.generate_batch`` call share one sampler call
(one captured program per batch size and bucket on CUDA) instead of N.

Requests group by (steps, piano, bucketed duration) — the sampler program
is shape-specialised, so only compatible requests share a call; stragglers
re-queue for the next group. Given ``metrics`` (``server.ServerMetrics``,
as ``serve`` passes it), each batch's size and each request's seconds in
the queue go to it, with the pipeline's ``last_timings`` of the call. A
request served alone draws
different noise rows than the same request inside a batch (one PRNG tensor
per call), which is within serving semantics — generation is stochastic
per request anyway.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _Request:
    video_path: str
    prompt: str
    steps: int
    piano: bool
    duration_s: float
    future: Future
    enqueued: float = dataclasses.field(default_factory=time.monotonic)


class RequestBatcher:
    """Owns a worker thread that drains a request queue into batched
    pipeline calls. ``submit`` returns a Future resolving to (wav, sr)."""

    def __init__(self, pipeline, max_batch: int = 8,
                 window_ms: float = 50.0, max_duration_s: float = 30.0,
                 metrics=None):
        self.pipeline = pipeline
        self.metrics = metrics
        self.max_batch = max(1, max_batch)
        self.window_s = window_ms / 1000.0
        self.max_duration_s = max_duration_s
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, video_path: Optional[str], prompt: str, *,
               steps: int = 25, piano: bool = False,
               duration_s: Optional[float] = None) -> Future:
        from v2ap_torch.data.video_io import probe_duration, read_video_frames

        if duration_s is None:
            dur = probe_duration(video_path) if video_path else None
            if dur is None and video_path:
                # Metadata probe failed (missing/corrupt container header);
                # fall back to the same decoded-stream duration the unbatched
                # path uses rather than silently truncating to 10 s.
                import logging
                logging.getLogger(__name__).warning(
                    "duration probe failed for %s; decoding stream",
                    video_path)
                _, dur = read_video_frames(video_path)
            duration_s = min(dur or 10.0, self.max_duration_s)
        fut: Future = Future()
        self._q.put(_Request(video_path, prompt, int(steps), bool(piano),
                             round(float(duration_s), 1), fut))
        return fut

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=5.0)
        self._drain_pending(RuntimeError("RequestBatcher closed"))

    def _drain_pending(self, exc: Exception) -> None:
        """Fail every request still sitting in the queue (including leftovers
        re-queued by _collect) so HTTP handler threads don't block on the
        full result timeout during shutdown."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is not None and not r.future.done():
                r.future.set_exception(exc)

    @staticmethod
    def _key(r: _Request):
        return (r.steps, r.piano, r.duration_s)

    def _collect(self, first: _Request):
        """First request + everything compatible arriving inside the window
        (incompatible arrivals re-queue for the next group)."""
        batch = [first]
        deadline = time.monotonic() + self.window_s
        leftover = []
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                r = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if r is None:
                self._stop = True
                break
            if self._key(r) == self._key(first):
                batch.append(r)
            else:
                leftover.append(r)
        for r in leftover:
            self._q.put(r)
        return batch

    def _worker(self) -> None:
        while True:
            first = self._q.get()
            if first is None or self._stop:
                # a request taken off the queue at shutdown fails too (the
                # JAX batcher drops it, and its client waits out its timeout)
                if first is not None:
                    first.future.set_exception(
                        RuntimeError("RequestBatcher closed"))
                break
            batch = self._collect(first)
            if self.metrics is not None:
                now = time.monotonic()
                self.metrics.observe_batch([now - r.enqueued for r in batch])
            try:
                wavs, sr = self.pipeline.generate_batch(
                    [r.video_path for r in batch],
                    [r.prompt for r in batch],
                    duration_s=first.duration_s, steps=first.steps,
                    piano=first.piano, seed=int(time.time_ns() % (1 << 31)))
                if self.metrics is not None:
                    self.metrics.observe_stages(
                        getattr(self.pipeline, "last_timings", {}))
                for i, r in enumerate(batch):
                    r.future.set_result((np.asarray(wavs[i]), sr))
            except Exception as exc:           # noqa: BLE001 — fail the batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(exc)
        self._drain_pending(RuntimeError("RequestBatcher worker exited"))
