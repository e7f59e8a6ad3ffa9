"""The port's span recorder and the spans and counters of its serving path,
on the CPU: ``SpanRecorder`` (nesting, parents, one id a call,
CUDA events only on a CUDA device, their pool), the stages and counters a
``generate`` / ``generate_batch`` call reports in ``last_timings`` (the
key sets, ``host_syncs`` against a count by hand, ``since_init`` a new
dict each call), no synchronisation on the serving path, the ``v2ap.*``
ranges in a profiler's trace, the launches a captured program's replays
add to ``launch_counts``, and the server's batcher and stage metrics."""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from v2ap_torch import config as t_config
from v2ap_torch.models.clip_vit import clip_tiny_test
from v2ap_torch.models.t5 import t5_tiny_test
from v2ap_torch.ops import flash_attention as fa
from v2ap_torch.pipelines import generate as t_generate
from v2ap_torch.serving.batcher import RequestBatcher
from v2ap_torch.serving.server import ServerMetrics
from v2ap_torch.utils import jitting
from v2ap_torch.utils import observability as obs

torch.set_num_threads(2)

PROMPT = "a calm piano piece in a quiet room"
CLIP_S = 0.4                    # 10 frames and 10 strips at 25 fps


class FakeEvent:
    """A CUDA timing event on a clock the test sets (milliseconds)."""
    clock = [0.0]
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = FakeEvent.clock[0]

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.clock[0], FakeEvent.made = 0.0, 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return FakeEvent


def _nested(rec, clock=None):
    """a (0-10) holding b (1-4) holding c (2-3), then d (10-12): the clock
    (ms) set before each event when ``clock`` is given."""
    def at(t):
        if clock is not None:
            clock[0] = t

    with rec.call() as call:
        at(0.0)
        with rec.span("a"):
            at(1.0)
            with rec.span("b"):
                at(2.0)
                with rec.span("c"):
                    at(3.0)
                at(4.0)
            rec.count("waits")
            rec.count("waits", 2)
            at(10.0)
        with rec.span("d"):
            at(12.0)
    return call


def test_recorder_nesting_parents_and_call_id(fake_cuda):
    """Spans nest under the span open around them and share their call's
    id; a new call gets a new id; on CUDA the seconds are the events'."""
    rec = obs.SpanRecorder("cuda")
    call = _nested(rec, fake_cuda.clock)
    spans = rec.resolve()
    assert rec.last is call and [s.name for s in spans] == list("abcd")
    assert [s.parent for s in spans] == [None, 0, 1, None]
    assert {s.call_id for s in spans} == {call.id}
    assert [round(s.seconds, 9) for s in spans] == [0.010, 0.003, 0.001,
                                                     0.002]
    assert call.counters == {"waits": 3}
    assert rec.totals() == pytest.approx({"a": 0.010, "b": 0.003, "c": 0.001,
                                          "d": 0.002})
    again = _nested(rec)
    assert again.id != call.id and rec.last is again
    # outside a call a span is only its profiler range, a count is dropped
    with rec.span("loose"):
        rec.count("waits")
    assert rec.last is again and "loose" not in rec.totals(again)


def test_recorder_events_only_on_cuda_and_pooled(fake_cuda):
    """On the CPU no CUDA event is made and the host clock times a span;
    on CUDA a span takes two events, from the pool that resolved calls
    refill, and a call joined from inside another is the same call."""
    rec = obs.SpanRecorder("cpu")
    _nested(rec)
    assert fake_cuda.made == 0 and all(s.events is None
                                       and s.seconds >= 0
                                       for s in rec.resolve())
    rec = obs.SpanRecorder("cuda")
    first = _nested(rec)
    assert fake_cuda.made == 8 and all(s.events for s in first.spans)
    rec.resolve()
    assert all(s.events is None for s in first.spans)
    with rec.call() as outer:
        with rec.call() as inner, rec.span("x"):
            pass
    assert inner is outer and fake_cuda.made == 8      # reused, none new
    _nested(rec)
    # the pool's six and two new: the joined call was not resolved, so
    # its two are not back
    assert fake_cuda.made == 10


def _cfg():
    cfg = t_config.tiny_test()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dim_text=16, dim_context=32, num_channels=8,
        video2roll=True))


@pytest.fixture(scope="module")
def pipe():
    return t_generate.V2APipeline(_cfg(), device="cpu",
                                  t5_config=t5_tiny_test(),
                                  clip_config=clip_tiny_test(),
                                  quantize_towers=False)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(1).integers(0, 256, (10, 28, 28, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def strips():
    return np.random.default_rng(6).integers(0, 256, (10, 100, 900),
                                             dtype=np.uint8)


def _v2a(pipe, frames):
    return pipe.generate(None, steps=2, seed=5,
                         frames_cache=[(frames, CLIP_S, 1)])


def _v2p(pipe, frames, strips):
    """V2P with a prompt at the shipped strides (frame 3, strip 2)."""
    saved = pipe.frame_stride, pipe.strip_stride
    pipe.frame_stride, pipe.strip_stride = 3, 2
    try:
        return pipe.generate(None, PROMPT, piano=True, steps=2, seed=5,
                             frames_cache=[(frames, CLIP_S, 1)],
                             strips_cache=[(strips, CLIP_S)])
    finally:
        pipe.frame_stride, pipe.strip_stride = saved


def _batch(pipe, frames):
    return pipe.generate_batch([None, None], ["", PROMPT],
                               duration_s=CLIP_S, steps=2, seed=3,
                               frames_caches=[[(frames, CLIP_S, 1)]] * 2)


# host_syncs by hand. V2A at frame stride 1: the one 64-frame chunk's
# upload, the nearest-frame index, the waveform's copy back = 3. V2P at
# strides 3 / 2: the strips and their blend plan (i0, i1, w) 4, the chunk
# 1, the stride-3 blend (w, i0, i1) 3, T5's mask and ids 2, the copy back 1
# = 11. A batch of two clips at stride 1: 2 a clip, the dropped-prompt
# flags 1, T5 2, the copy back 1 = 8.
CASES = {
    "v2a": (_v2a, 3, {"video_encode_s", "upload_s", "conditioning_s",
                      "sample_s", "decode_s"},
            ("video_encode", "conditioning", "sample", "decode")),
    "v2p": (_v2p, 11, {"strips_s", "video_encode_s", "upload_s",
                       "text_encode_s", "roll_s", "conditioning_s",
                       "sample_s", "decode_s"},
            ("strips", "video_encode", "conditioning", "sample", "decode")),
    "batch": (_batch, 8, {"video_encode_s", "upload_s", "text_encode_s",
                          "conditioning_s", "sample_s", "decode_s"},
              ("conditioning", "sample", "decode")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_call_timings_and_host_syncs(pipe, frames, strips, case):
    """Each call's ``last_timings``: the stage keys, ``host_syncs`` as
    counted by hand, and ``since_init`` (init and capture seconds); the
    top-level spans follow one another, and a stage sums its spans."""
    run, syncs, stages, top = CASES[case]
    run(pipe, *((frames, strips) if case == "v2p" else (frames,)))
    timings = pipe.last_timings
    assert set(timings) == stages | {"host_syncs", "since_init"}
    assert timings["host_syncs"] == syncs
    assert timings["since_init"] == {
        "init_s": pipe.init_s, "init_by_module": pipe.init_by_module,
        "capture_s": 0.0}
    assert pipe.init_s > 0
    assert set(pipe.init_by_module) == {"cfm", "codec", "t5", "towers"}
    assert 0 < sum(pipe.init_by_module.values()) <= pipe.init_s
    spans = pipe.spans.resolve()
    assert tuple(s.name for s in spans if s.parent is None) == top
    ends = [(s.start, s.end) for s in spans if s.parent is None]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert timings["upload_s"] == pytest.approx(sum(
        s.seconds for s in spans if s.name == "frames.upload"))
    assert pipe.tower_seconds == {"clip_vit": pytest.approx(sum(
        s.seconds for s in spans if s.name == "tower.clip_vit"))}


def test_since_init_is_a_new_dict_every_call(pipe, frames):
    """The harness copies ``last_timings`` shallowly: ``since_init`` must
    not be one dict that every call shares."""
    _v2a(pipe, frames)
    first = pipe.last_timings
    _v2a(pipe, frames)
    assert first["since_init"] is not pipe.last_timings["since_init"]
    assert (first["since_init"]["init_by_module"]
            is not pipe.last_timings["since_init"]["init_by_module"])
    assert first is not pipe.last_timings


def test_serving_path_never_synchronises(pipe, frames, strips,
                                         monkeypatch):
    """No stage is timed by a synchronisation any more: the serving path
    neither calls ``torch.cuda.synchronize`` nor has a sync helper."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    _v2a(pipe, frames)
    _v2p(pipe, frames, strips)
    _batch(pipe, frames)
    assert calls == []
    assert not hasattr(pipe, "_sync")
    assert "synchronize(" not in inspect.getsource(t_generate)


def test_spans_are_ranges_in_the_profilers_trace(pipe, frames, tmp_path):
    """A profiled ``generate`` carries each span as a ``user_annotation``
    event ``v2ap.<name>`` on the kernels' clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _v2a(pipe, frames)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"v2ap.video_encode", "v2ap.frames.upload", "v2ap.tower.clip_vit",
            "v2ap.conditioning", "v2ap.sample", "v2ap.decode"} <= names


def test_replays_count_the_launches_their_capture_recorded(monkeypatch):
    """A captured program's replays add the launches its wrappers recorded
    while it was captured; the eager warm-up counts as it runs (the CUDA
    capture machinery stubbed)."""
    capturing = [False]

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    class Capture:
        def __init__(self, graph, **kw):
            pass

        def __enter__(self):
            capturing[0] = True

        def __exit__(self, *exc):
            capturing[0] = False

    import contextlib
    for name, value in (("Stream", lambda *a: Stream()),
                        ("current_stream", lambda *a: Stream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("CUDAGraph", Graph), ("graph", Capture),
                        ("memory_reserved", lambda *a: 0),
                        ("is_current_stream_capturing",
                         lambda: capturing[0])):
        monkeypatch.setattr(torch.cuda, name, value)

    def program(x):
        fa.count_launch("flash_attention_packed")
        fa.count_launch("flash_attention_packed")
        fa.count_launch("flash_attention")
        return x * 2

    before = dict(fa.launch_counts)
    graphs = jitting.CapturedPrograms()
    for _ in range(3):
        graphs.run("k", program, (torch.ones(2),))
    launched = {k: fa.launch_counts[k] - before[k] for k in before}
    # the warm-up's 2 + 1, then 3 replays of 2 + 1 each
    assert launched == {**dict.fromkeys(before, 0),
                        "flash_attention_packed": 8, "flash_attention": 4}
    assert Graph.replays == 3 and len(graphs.captures) == 1


def test_batcher_queue_waits_batch_sizes_and_stages():
    """The batcher records each batch's size and each request's queue wait,
    the pipeline's ``last_timings`` go to the stage totals, and
    ``ServerMetrics`` exports them as JSON and Prometheus text."""
    class Pipeline:
        last_timings = {}

        def generate_batch(self, paths, prompts, **kw):
            self.last_timings = {"sample_s": 0.5, "host_syncs": 4,
                                 "since_init": {"init_s": 1.0}}
            return np.zeros((len(paths), 10), np.float32), 24_000

    metrics = ServerMetrics()
    b = RequestBatcher(Pipeline(), max_batch=3, window_ms=5000.0,
                       metrics=metrics)
    try:
        futs = [b.submit(None, f"p{i}", steps=2, duration_s=1.0)
                for i in range(3)]
        for f in futs:
            f.result(timeout=30)
    finally:
        b.close()
    snap = metrics.snapshot()
    assert snap["batcher"]["batches"] == 1
    assert snap["batcher"]["requests"] == 3
    assert snap["batcher"]["mean_batch_size"] == 3.0
    assert snap["batcher"]["queue_wait_p50_s"] >= 0.0
    assert snap["stages"] == {"sample_s": {"total": 0.5, "calls": 1},
                              "host_syncs": {"total": 4, "calls": 1}}
    metrics.observe("v2a", 0.7, True)
    text = metrics.prometheus()
    for line in ('v2ap_requests_total{endpoint="v2a"} 1',
                 "v2ap_batches_total 1", "v2ap_batched_requests_total 3",
                 'v2ap_queue_wait_seconds{quantile="0.50"}',
                 'v2ap_stage_seconds_total{stage="sample"} 0.5',
                 'v2ap_stage_calls_total{stage="sample"} 1',
                 "v2ap_host_syncs_total 4"):
        assert line in text, line
