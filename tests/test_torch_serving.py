"""The port's serving layer on the CPU, mirroring ``tests/test_serving.py``
on the port's tiny pipeline (``device="cpu"``, bf16 towers): the HTTP
server end to end (healthz, form, metrics, POST v2a, 400, 411, 413, 504,
concurrent coalescing, fewstep, the demo examples), the request batcher's
grouping and error propagation, and the ``Predictor`` / ``app`` entry
points."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_pipeline import tiny_pipeline_cfg, write_synthetic_video
from v2ap_torch import config as t_config
from v2ap_torch.data.audio_io import read_wav
from v2ap_torch.models.clip_vit import clip_tiny_test
from v2ap_torch.models.t5 import t5_tiny_test
from v2ap_torch.pipelines.generate import V2APipeline
from v2ap_torch.serving.batcher import RequestBatcher
from v2ap_torch.serving.server import serve

torch.set_num_threads(2)


def _port_cfg():
    """``tiny_pipeline_cfg()`` (the JAX serving tests' config) in the
    port's config classes."""
    import dataclasses
    j = tiny_pipeline_cfg()
    cfg = t_config.tiny_test()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dim_text=j.model.dim_text, dim_context=j.model.dim_context,
        num_channels=j.model.num_channels))


def _pipeline():
    return V2APipeline(_port_cfg(), device="cpu", t5_config=t5_tiny_test(),
                       clip_config=clip_tiny_test(), quantize_towers=False)


@pytest.fixture(scope="module")
def served_pipeline():
    pipe = _pipeline()
    calls = []
    batch = pipe.generate_batch

    def counted(paths, prompts, **kw):
        calls.append(len(paths))
        return batch(paths, prompts, **kw)

    pipe.generate_batch = counted
    # a window long enough for four concurrent uploads on a loaded host; a
    # batch of four closes at once
    server = serve(pipe, port=0, block=False, window_ms=2000.0, max_batch=4)
    yield pipe, server, calls
    server.shutdown()
    server.batcher.close()


def _multipart(fields, files):
    boundary = "----v2apboundary"
    buf = io.BytesIO()
    for name, value in fields.items():
        buf.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, (fname, payload) in files.items():
        buf.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="{name}"; filename="{fname}"\r\n'
                  f"Content-Type: video/mp4\r\n\r\n".encode())
        buf.write(payload)
        buf.write(b"\r\n")
    buf.write(f"--{boundary}--\r\n".encode())
    return buf.getvalue(), f"multipart/form-data; boundary={boundary}"


def _video_bytes(tmp_path, name="in.mp4", frames=6, fps=4):
    path = str(tmp_path / name)
    assert write_synthetic_video(path, frames=frames, fps=fps)
    with open(path, "rb") as f:
        return f.read()


def _post(port, fields, files, path="/v2a", timeout=600):
    body, ctype = _multipart(fields, files)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), r.headers["Content-Type"]


def test_healthz(served_pipeline):
    pipe, server, _ = served_pipeline
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        info = json.loads(r.read())
    assert info == {"status": "ok", "model_dim": pipe.cfg.model.dim,
                    "depth": pipe.cfg.model.depth, "notes": 51}


def test_index_form(served_pipeline):
    _, server, _ = served_pipeline
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
        html = r.read().decode()
    assert "<form" in html and "video" in html


def test_metrics_endpoint(served_pipeline, tmp_path):
    """/metrics after a real request: counters and latency quantiles, JSON
    and Prometheus text."""
    _, server, _ = served_pipeline
    port = server.server_address[1]
    _post(port, {"prompt": "", "steps": "2"},
          {"video": ("m.mp4", _video_bytes(tmp_path, "m.mp4"))})
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
        m = json.loads(r.read())
    assert m["v2a"]["requests"] >= 1 and m["v2a"]["errors"] == 0
    assert m["v2a"]["latency_p50_s"] > 0
    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                 headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req) as r:
        text = r.read().decode()
    assert 'v2ap_requests_total{endpoint="v2a"}' in text
    assert 'quantile="0.50"' in text


def test_post_v2a_generates_wav(served_pipeline, tmp_path):
    """A 1.5 s upload with a prompt: a WAV of the clip's 112 latents (1.5 s
    at 75 Hz, rounded) at 24 kHz."""
    _, server, _ = served_pipeline
    port = server.server_address[1]
    data, ctype = _post(port, {"prompt": "beep", "steps": "2"},
                        {"video": ("in.mp4", _video_bytes(tmp_path))})
    assert ctype == "audio/wav" and data[:4] == b"RIFF"
    out = tmp_path / "out.wav"
    out.write_bytes(data)
    audio, sr = read_wav(str(out))
    assert sr == 24_000 and audio.shape == (1, 112 * 320)
    assert np.isfinite(audio).all()


def test_post_missing_video_is_400(served_pipeline):
    _, server, _ = served_pipeline
    port = server.server_address[1]
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"prompt": "x"}, {}, timeout=60)
    assert exc.value.code == 400


def test_post_without_length_is_411(served_pipeline):
    """A body announced with no Content-Length is refused before any read."""
    import http.client
    _, server, _ = served_pipeline
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=60)
    try:
        conn.putrequest("POST", "/v2a")
        conn.putheader("Content-Type", "multipart/form-data; boundary=x")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 411
        assert json.loads(resp.read())["error"] == "Content-Length required"
    finally:
        conn.close()


def test_request_batcher_coalesces_concurrent():
    """Concurrent compatible requests share ONE generate_batch call;
    incompatible ones (different steps) get their own."""
    calls = []

    class FakePipeline:
        def generate_batch(self, paths, prompts, *, duration_s, steps,
                           piano, seed):
            calls.append((len(paths), steps))
            time.sleep(0.05)
            return np.zeros((len(paths), 100), np.float32), 24_000

    b = RequestBatcher(FakePipeline(), max_batch=8, window_ms=200.0)
    try:
        futs = [b.submit(None, f"p{i}", steps=4, duration_s=2.0)
                for i in range(3)]
        other = b.submit(None, "q", steps=8, duration_s=2.0)
        for f in futs + [other]:
            wav, sr = f.result(timeout=30)
            assert sr == 24_000 and wav.shape == (100,)
    finally:
        b.close()
    assert (1, 8) in calls                   # incompatible steps: own call
    assert sum(n for n, s in calls if s == 4) == 3
    assert len([c for c in calls if c[1] == 4]) <= 2   # coalesced (usually 1)


def test_request_batcher_propagates_errors():
    class Broken:
        def generate_batch(self, *a, **k):
            raise RuntimeError("boom")

    b = RequestBatcher(Broken(), max_batch=4, window_ms=10.0)
    try:
        fut = b.submit(None, "x", steps=2, duration_s=1.0)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    finally:
        b.close()


def test_request_batcher_drains_on_close():
    """Requests still queued when the batcher closes fail at once instead
    of waiting out their timeout, the one the worker takes off the queue
    as it stops included."""
    started, gate = threading.Event(), threading.Event()

    class Slow:
        def generate_batch(self, paths, prompts, **kw):
            started.set()
            gate.wait(10)
            return np.zeros((len(paths), 10), np.float32), 24_000

    b = RequestBatcher(Slow(), max_batch=1, window_ms=1.0)
    first = b.submit(None, "a", steps=2, duration_s=1.0)
    assert started.wait(10)                  # the worker holds the first
    queued = b.submit(None, "b", steps=2, duration_s=1.0)
    closer = threading.Thread(target=b.close)
    closer.start()
    deadline = time.monotonic() + 10
    while not b._stop and time.monotonic() < deadline:   # close() began
        time.sleep(0.01)
    gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    assert first.result(timeout=30)[0].shape == (10,)
    with pytest.raises(RuntimeError, match="RequestBatcher"):
        queued.result(timeout=30)


def test_concurrent_posts_share_one_batch(served_pipeline, tmp_path):
    """Four simultaneous uploads ride ONE generate_batch call of the
    micro-batcher (the server default) and all come back as audio."""
    _, server, calls = served_pipeline
    port = server.server_address[1]
    payload = _video_bytes(tmp_path, "cc.mp4")
    results = {}

    def post(tag):
        results[tag], _ = _post(port, {"prompt": tag, "steps": "2"},
                                {"video": ("in.mp4", payload)})

    before = len(calls)
    threads = [threading.Thread(target=post, args=(t,)) for t in "abcd"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert set(results) == set("abcd")
    for wav_bytes in results.values():
        assert wav_bytes[:4] == b"RIFF" and len(wav_bytes) > 24_000
    assert calls[before:] == [4]


def test_upload_size_cap_413():
    """Uploads beyond max_upload_mb are refused with 413 before the body is
    read, and counted as errors."""
    pipe = _pipeline()
    server = serve(pipe, port=0, block=False, batch_requests=False,
                   max_upload_mb=0.001)
    try:
        port = server.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"prompt": ""}, {"video": ("big.mp4", b"x" * 4096)},
                  timeout=60)
        assert exc.value.code == 413
        assert json.loads(exc.value.read())["error"] == "upload too large"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            assert json.loads(r.read())["v2a"]["errors"] >= 1
    finally:
        server.shutdown()


def test_request_timeout_504(tmp_path, monkeypatch):
    """A stalled generate fails the request with 504 after
    request_timeout_s instead of hanging the client."""
    pipe = _pipeline()

    def stalled_generate(*a, **k):
        time.sleep(5.0)
        raise AssertionError("unreachable in this test")

    monkeypatch.setattr(pipe, "generate", stalled_generate)
    server = serve(pipe, port=0, block=False, batch_requests=False,
                   request_timeout_s=0.5)
    try:
        port = server.server_address[1]
        t0 = time.perf_counter()
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, {"prompt": ""},
                  {"video": ("t.mp4", _video_bytes(tmp_path, "t.mp4", 4))},
                  timeout=60)
        assert exc.value.code == 504
        assert time.perf_counter() - t0 < 4.0     # failed fast, not at 5 s
    finally:
        server.shutdown()


def test_post_fewstep_mode(served_pipeline, tmp_path):
    """The fewstep field routes through generate's few-step sampler (one
    forward a step, no CFG), not the batcher, and still returns a WAV."""
    _, server, calls = served_pipeline
    port = server.server_address[1]
    before = len(calls)
    data, _ = _post(port, {"prompt": "", "steps": "25", "fewstep": "2"},
                    {"video": ("fs.mp4", _video_bytes(tmp_path, "fs.mp4"))})
    assert data[:4] == b"RIFF"
    assert len(calls) == before


def test_example_endpoint(served_pipeline):
    """GET /example synthesizes a demo clip server-side and runs the real
    generate path, in both modes; an unknown mode is a 400."""
    _, server, _ = served_pipeline
    port = server.server_address[1]
    for mode in ("v2a", "v2p"):
        url = (f"http://127.0.0.1:{port}/example?mode={mode}"
               f"&steps=2&seconds=2")
        with urllib.request.urlopen(url, timeout=600) as r:
            data = r.read()
            assert r.status == 200
        assert data[:4] == b"RIFF" and len(data) > 1000, mode
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/example?mode=nope",
                               timeout=60)
    assert exc.value.code == 400


def test_predictor_tiny_on_cpu(tmp_path, monkeypatch):
    """Predictor(tiny=True, device="cpu"): without V2AP_INT8_TOWERS and
    without a gate file it serves the JAX default, int8 towers; the
    generated audio lands beside the target path. ``setup(ckpt=)`` loads
    a saved tiny pipeline's weights and ``predict`` serves them: the same
    audio as the pipeline that saved them."""
    from v2ap_torch.predict import Predictor
    from v2ap_torch.utils.checkpoint import save_model

    monkeypatch.delenv("V2AP_INT8_TOWERS", raising=False)
    monkeypatch.setenv("V2AP_INT8_GATE_FILE", str(tmp_path / "none.json"))
    p = Predictor(tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="setup"):
        p.predict("x.mp4")
    p.setup()
    assert p.pipeline.quantize_towers and p.pipeline._tower_tag == "int8"
    video = str(tmp_path / "clip.mp4")
    assert write_synthetic_video(video, frames=6, fps=4)
    out = p.predict(video, v2a_num_steps=2, out_dir=str(tmp_path / "o"))
    assert out.endswith(".generated.wav") or out.endswith(".generated.mp4")
    if out.endswith(".wav"):
        audio, sr = read_wav(out)
        assert sr == 24_000 and audio.shape == (1, 112 * 320)

    # another seed's weights, saved as load_weights reads them
    saver = Predictor(tiny=True, device="cpu")
    saver.setup()
    with torch.no_grad():
        for module in (saver.pipeline.cfm, saver.pipeline.clip):
            for t in module.parameters():
                t.add_(0.01 * torch.randn(t.shape, generator=torch.Generator()
                                          .manual_seed(t.numel())))
    ckpt = tmp_path / "ckpt"
    save_model(str(ckpt / "cfm"), saver.pipeline.cfm)
    save_model(str(ckpt / "clip"), saver.pipeline.clip)
    loaded = Predictor(tiny=True, device="cpu")
    loaded.setup(ckpt=str(ckpt))
    for module in ("cfm", "clip"):
        got = getattr(loaded.pipeline, module).state_dict()
        for name, t in getattr(saver.pipeline, module).state_dict().items():
            assert torch.equal(got[name], t), (module, name)
    a = loaded.predict(video, v2a_num_steps=2, out_dir=str(tmp_path / "a"))
    b = saver.predict(video, v2a_num_steps=2, out_dir=str(tmp_path / "b"))
    c = p.predict(video, v2a_num_steps=2, out_dir=str(tmp_path / "c"))
    if a.endswith(".wav"):
        np.testing.assert_array_equal(read_wav(a)[0], read_wav(b)[0])
        assert not np.array_equal(read_wav(a)[0], read_wav(c)[0])


def test_app_serves_the_predictor_pipeline(monkeypatch):
    """``python -m v2ap_torch.app --tiny --cpu`` builds the tiny Predictor
    on the CPU and hands its pipeline to serve()."""
    from v2ap_torch import app
    from v2ap_torch.serving import server as server_mod

    seen = {}
    monkeypatch.setenv("V2AP_INT8_TOWERS", "0")
    monkeypatch.setattr(server_mod, "serve",
                        lambda pipe, host, port: seen.update(
                            pipe=pipe, host=host, port=port))
    assert app.main(["--tiny", "--cpu", "--port", "7999"]) == 0
    assert seen["port"] == 7999 and seen["host"] == "127.0.0.1"
    assert seen["pipe"].device.type == "cpu"
    assert seen["pipe"].cfg.model.num_channels == 8
