"""HTTP serving for V2A / V2P generation.

Counterpart of ``v2ap_tpu/serving/server.py``: a stdlib ThreadingHTTPServer
over the port's ``V2APipeline``, with

  GET  /            — minimal HTML upload form (the UI surface)
  GET  /example     — built-in demo: synthesizes a clip server-side and runs
                      it through the same generate path (?mode=v2a|v2p,
                      &steps=N), the reference's clickable examples
  GET  /healthz     — liveness + model info
  GET  /metrics     — request counters + latency quantiles, the batcher's
                      batches and queue waits, the pipeline's stage
                      seconds and host syncs (JSON; also Prometheus text
                      with Accept: text/plain; see below)
  POST /v2a, /v2p   — multipart video upload (+ optional ``prompt``,
                      ``steps`` fields) -> generated WAV (or muxed MP4 when
                      a muxer is available)

The pipeline is owned by the server process; uploads decode host-side
(cv2). An upload that does not decode is served unconditioned (zero frame
features), as the JAX server serves it.
Concurrent requests coalesce through a micro-batching scheduler
(``serving/batcher.py``): compatible requests arriving within the batching
window share ONE ``generate_batch`` call on the CFM's batch axis.
With batching disabled (``serve(..., batch_requests=False)``), device work
serialises through a lock instead.

What ``/metrics`` reports (``ServerMetrics``; JSON, or Prometheus text):

  * per endpoint: requests, errors, latency p50 / p90 / p99
    (``v2ap_requests_total``, ``v2ap_errors_total``,
    ``v2ap_latency_seconds``);
  * ``batcher``: batched calls, the requests they carried, the mean batch
    size and each request's wait in the batcher's queue, p50 / p90 / p99
    (``v2ap_batches_total``, ``v2ap_batched_requests_total``,
    ``v2ap_queue_wait_seconds``);
  * ``stages``: the pipeline's ``last_timings`` of every call, summed: each
    stage's seconds and calls (``v2ap_stage_seconds_total{stage=...}``,
    ``v2ap_stage_calls_total``: ``video_encode``, ``upload``,
    ``text_encode``, ``roll``, ``strips``, ``conditioning``, ``sample``,
    ``decode``) and the points where a call waited for the card
    (``v2ap_host_syncs_total``). On CUDA the stage seconds come from CUDA
    events, and a profiled run carries each stage as a ``v2ap.<stage>``
    range beside the kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures
import email
import email.policy
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ServerMetrics:
    """Thread-safe request counters + latency quantiles for /metrics.

    Per-endpoint counts, error counts, and p50/p90/p99 wall latency over a
    bounded reservoir of the most recent requests; the batcher's batches,
    the requests they carried and each request's seconds in its queue
    (``observe_batch``); and the pipeline's own numbers of every call
    (``observe_stages``: each stage's seconds and ``host_syncs`` from
    ``last_timings``), summed."""

    def __init__(self, reservoir: int = 1024):
        self._lock = threading.Lock()
        self._reservoir = reservoir
        self.counts: dict = {}
        self.errors: dict = {}
        self._lat: dict = {}              # endpoint -> deque of RECENT samples
        self.batches = 0
        self.batched_requests = 0
        self._waits = collections.deque(maxlen=reservoir)
        self.stage_totals: dict = {}      # last_timings key -> summed value
        self.stage_calls: dict = {}

    def observe(self, endpoint: str, seconds: float, ok: bool) -> None:
        with self._lock:
            self.counts[endpoint] = self.counts.get(endpoint, 0) + 1
            if not ok:
                self.errors[endpoint] = self.errors.get(endpoint, 0) + 1
            self._lat.setdefault(
                endpoint,
                collections.deque(maxlen=self._reservoir)).append(seconds)

    def observe_batch(self, waits) -> None:
        """One batched pipeline call: the seconds each of its requests
        waited in the batcher's queue (one per request)."""
        with self._lock:
            self.batches += 1
            self.batched_requests += len(waits)
            self._waits.extend(waits)

    def observe_stages(self, timings: dict) -> None:
        """One pipeline call's ``last_timings``: every number (the stages'
        seconds, ``host_syncs``) added to its total."""
        with self._lock:
            for key, value in timings.items():
                if isinstance(value, (int, float)):
                    self.stage_totals[key] = (self.stage_totals.get(key, 0)
                                              + value)
                    self.stage_calls[key] = self.stage_calls.get(key, 0) + 1

    @staticmethod
    def _quantiles(samples) -> dict:
        # quantiles over the most-recent window (a sorted reservoir that
        # evicts by VALUE would converge to all-time-worst)
        lat = sorted(samples)
        return {q: (round(lat[min(len(lat) - 1, int(f * len(lat)))], 4)
                    if lat else None)
                for q, f in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))}

    def _endpoints(self) -> dict:
        out = {}
        for ep, n in self.counts.items():
            q = self._quantiles(self._lat.get(ep, ()))
            out[ep] = {"requests": n, "errors": self.errors.get(ep, 0),
                       **{f"latency_{k}_s": v for k, v in q.items()}}
        return out

    def snapshot(self) -> dict:
        """The endpoints' rows by name, and ``batcher`` and ``stages``."""
        with self._lock:
            out = self._endpoints()
            q = self._quantiles(self._waits)
            out["batcher"] = {
                "batches": self.batches,
                "requests": self.batched_requests,
                "mean_batch_size": (round(self.batched_requests
                                          / self.batches, 4)
                                    if self.batches else None),
                **{f"queue_wait_{k}_s": v for k, v in q.items()}}
            out["stages"] = {key: {"total": total,
                                   "calls": self.stage_calls[key]}
                             for key, total in self.stage_totals.items()}
            return out

    def prometheus(self) -> str:
        lines = []
        snap = self.snapshot()
        batcher, stages = snap.pop("batcher"), snap.pop("stages")
        for ep, row in snap.items():
            lbl = f'{{endpoint="{ep}"}}'
            lines.append(f"v2ap_requests_total{lbl} {row['requests']}")
            lines.append(f"v2ap_errors_total{lbl} {row['errors']}")
            for k in ("latency_p50_s", "latency_p90_s", "latency_p99_s"):
                if row[k] is not None:
                    q = k.split("_")[1][1:]
                    lines.append(
                        f'v2ap_latency_seconds{{endpoint="{ep}",'
                        f'quantile="0.{q}"}} {row[k]}')
        lines.append(f"v2ap_batches_total {batcher['batches']}")
        lines.append(f"v2ap_batched_requests_total {batcher['requests']}")
        for k in ("queue_wait_p50_s", "queue_wait_p90_s", "queue_wait_p99_s"):
            if batcher[k] is not None:
                lines.append(f'v2ap_queue_wait_seconds{{quantile='
                             f'"0.{k.split("_")[2][1:]}"}} {batcher[k]}')
        for key, row in stages.items():
            if key.endswith("_s"):
                lbl = f'{{stage="{key[:-2]}"}}'
                lines.append(f"v2ap_stage_seconds_total{lbl} {row['total']}")
                lines.append(f"v2ap_stage_calls_total{lbl} {row['calls']}")
            else:
                lines.append(f"v2ap_{key}_total {row['total']}")
        return "\n".join(lines) + "\n"

_FORM = """<!doctype html>
<title>v2ap-torch</title>
<h2>Video-to-Audio / Video-to-Piano (PyTorch)</h2>
<form action="/{mode}" method="post" enctype="multipart/form-data">
  <p><input type="file" name="video" accept="video/mp4" required></p>
  <p>Prompt: <input type="text" name="prompt" size="48"></p>
  <p>Steps: <input type="number" name="steps" value="25" min="2" max="64">
     Mode: <select name="mode"><option value="v2a">general audio</option>
           <option value="v2p">piano</option></select></p>
  <p><button type="submit">Generate</button></p>
</form>
<p>Examples (no upload needed):
   <a href="/example?mode=v2a">general audio</a> ·
   <a href="/example?mode=v2p">piano</a></p>
"""


class V2APHandler(BaseHTTPRequestHandler):
    pipeline = None
    batcher = None                    # RequestBatcher when batching is on
    metrics = ServerMetrics()
    lock = threading.Lock()
    # request hardening: bound what one request can cost
    max_upload_bytes = 256 * 1024 * 1024   # 413 beyond this; serve() overrides
    request_timeout_s = 600.0              # 504 when decode+generate exceeds it

    def _send(self, code: int, body: bytes, ctype: str = "text/html"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            if "text/plain" in (self.headers.get("Accept") or ""):
                self._send(200, self.metrics.prometheus().encode(),
                           "text/plain; version=0.0.4")
            else:
                self._send(200, json.dumps(self.metrics.snapshot()).encode(),
                           "application/json")
        elif self.path == "/healthz":
            cfg = self.pipeline.cfg
            info = {"status": "ok", "model_dim": cfg.model.dim,
                    "depth": cfg.model.depth, "notes": cfg.model.notes}
            self._send(200, json.dumps(info).encode(), "application/json")
        elif self.path.split("?")[0] == "/example":
            self._serve_example()
        else:
            self._send(200, _FORM.format(mode="v2a").encode())

    def _serve_example(self):
        from urllib.parse import parse_qs, urlsplit
        q = parse_qs(urlsplit(self.path).query)
        mode = (q.get("mode") or ["v2a"])[0]
        t0 = time.perf_counter()
        try:
            from v2ap_torch.serving.examples import EXAMPLES, example_clip_path
            if mode not in EXAMPLES:
                self.metrics.observe("example", time.perf_counter() - t0,
                                    False)
                self._send(400, json.dumps(
                    {"error": f"unknown example mode {mode!r}",
                     "modes": list(EXAMPLES)}).encode(), "application/json")
                return
            steps = max(2, min(64, int((q.get("steps") or ["25"])[0])))
            seconds = max(2.0, min(30.0,
                                   float((q.get("seconds") or ["6"])[0])))
            video = example_clip_path(mode, seconds=seconds)
            with self.lock:
                wav, sr = self.pipeline.generate(
                    video, "", steps=steps, piano=mode == "v2p")
                self.metrics.observe_stages(self.pipeline.last_timings)
            from v2ap_torch.data.audio_io import write_wav
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(tmp, "out.wav")
                write_wav(out, wav, sr)
                with open(out, "rb") as f:
                    data = f.read()
        except Exception as exc:
            self.metrics.observe("example", time.perf_counter() - t0, False)
            self._send(500, json.dumps({"error": str(exc)}).encode(),
                       "application/json")
            return
        self.metrics.observe("example", time.perf_counter() - t0, True)
        self._send(200, data, "audio/wav")

    def _parse_multipart(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        return self._parse_multipart_body(body)

    def _parse_multipart_body(self, body: bytes):
        msg = email.message_from_bytes(
            b"Content-Type: " + self.headers["Content-Type"].encode()
            + b"\r\n\r\n" + body, policy=email.policy.default)
        fields, files = {}, {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            filename = part.get_filename()
            payload = part.get_payload(decode=True)
            if filename:
                files[name] = (filename, payload)
            else:
                fields[name] = (payload or b"").decode(errors="replace")
        return fields, files

    def do_POST(self):
        # metrics are observed BEFORE the response bytes go out: a client that
        # finishes reading its response and immediately scrapes /metrics must
        # see its own request counted (observing in a ``finally`` after
        # ``_send`` raced exactly that scrape)
        piano = self.path.rstrip("/").endswith("v2p")
        t0 = time.perf_counter()

        def done(ok: bool):
            self.metrics.observe("v2p" if piano else "v2a",
                                 time.perf_counter() - t0, ok)

        try:
            # upload size cap BEFORE reading the body: Content-Length is
            # client-controlled, so an unbounded read was a one-request
            # memory DoS (old behavior trusted it straight into memory)
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = -1
            if length <= 0:
                done(False)
                self._send(411, b'{"error": "Content-Length required"}',
                           "application/json")
                return
            if length > self.max_upload_bytes:
                done(False)
                self._send(413, json.dumps(
                    {"error": "upload too large",
                     "max_bytes": self.max_upload_bytes}).encode(),
                    "application/json")
                return
            fields, files = self._parse_multipart_body(self.rfile.read(length))
            if "video" not in files:
                done(False)
                self._send(400, b'{"error": "missing video upload"}',
                           "application/json")
                return
            if fields.get("mode") == "v2p":
                piano = True
            prompt = fields.get("prompt", "")
            steps = max(2, min(64, int(fields.get("steps", "25") or 25)))
            fewstep = None
            if fields.get("fewstep"):
                fewstep = max(1, min(16, int(fields["fewstep"])))
            _, payload = files["video"]
            with tempfile.TemporaryDirectory() as tmp:
                video_path = os.path.join(tmp, "input.mp4")
                with open(video_path, "wb") as f:
                    f.write(payload)
                if self.batcher is not None and fewstep is None:
                    wav, sr = self.batcher.submit(
                        video_path, prompt, steps=steps,
                        piano=piano).result(timeout=self.request_timeout_s)
                else:
                    # per-request timeout on the decode+generate path: a
                    # malformed container can stall the host decoder; the
                    # request must fail fast (the stuck worker thread keeps
                    # the device lock until it dies — the timeout bounds the
                    # CLIENT's wait, and the watchdog below surfaces it)
                    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)

                    def work():
                        with self.lock:
                            out = self.pipeline.generate(
                                video_path, prompt, steps=steps, piano=piano,
                                fewstep=fewstep)
                            self.metrics.observe_stages(
                                self.pipeline.last_timings)
                            return out

                    try:
                        wav, sr = ex.submit(work).result(
                            timeout=self.request_timeout_s)
                    finally:
                        ex.shutdown(wait=False)
                from v2ap_torch.data.audio_io import write_wav
                out_wav = os.path.join(tmp, "out.wav")
                write_wav(out_wav, wav, sr)
                with open(out_wav, "rb") as f:
                    data = f.read()
        except (TimeoutError, concurrent.futures.TimeoutError):
            done(False)
            self._send(504, json.dumps(
                {"error": "generation timed out",
                 "timeout_s": self.request_timeout_s}).encode(),
                "application/json")
            return
        except Exception as exc:
            done(False)
            self._send(500, json.dumps({"error": str(exc)}).encode(),
                       "application/json")
            return
        done(True)
        self._send(200, data, "audio/wav")

    def log_message(self, fmt, *args):  # quiet
        pass


def serve(pipeline, host: str = "127.0.0.1", port: int = 7860,
          block: bool = True, batch_requests: bool = True,
          max_batch: int = 8, window_ms: float = 50.0,
          max_upload_mb: float = 256.0, request_timeout_s: float = 600.0
          ) -> ThreadingHTTPServer:
    batcher, metrics = None, ServerMetrics()
    if batch_requests:
        from v2ap_torch.serving.batcher import RequestBatcher
        batcher = RequestBatcher(pipeline, max_batch=max_batch,
                                 window_ms=window_ms, metrics=metrics)
    handler = type("BoundHandler", (V2APHandler,),
                   {"pipeline": pipeline, "batcher": batcher,
                    "metrics": metrics,
                    "max_upload_bytes": int(max_upload_mb * 1024 * 1024),
                    "request_timeout_s": float(request_timeout_s)})
    server = ThreadingHTTPServer((host, port), handler)
    server.batcher = batcher          # so shutdown paths can close it
    if block:
        print(f"v2ap-torch serving on http://{host}:{port}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
