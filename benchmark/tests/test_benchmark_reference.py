"""The plain reference against ``v2ap_torch`` at miniature sizes on the
CPU, part by part, with the benchmark's own seeded weights; and what the
benchmark may import: nothing of JAX or the JAX package anywhere, nothing
of the port in the reference."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.harness import FORBIDDEN
from benchmark.reference import pipeline as reference
from benchmark.reference.cfm import CFM as RefCFM
from benchmark.system import System
from benchmark.tests.tiny import tiny_config, tiny_traffic
from benchmark.traffic import Traffic

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def mixed():
    cfg = tiny_config("mixed", frame_stride=2, strip_stride=2)
    w = weights.make(cfg, 7, torch.device("cpu"), with_t5=True)
    system = System(cfg, torch.device("cpu"))
    system.load(w)
    return cfg, w, system


def _close(a, b, tol=1e-4):
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    assert a.shape == b.shape
    assert (a - b).norm() <= tol * b.norm()


@pytest.mark.parametrize("tower", ["clip_vit", "clip_vit2", "clip_convnext",
                                   "dinov2"])
def test_tower_features_agree(mixed, tower):
    cfg, w, system = mixed
    frames = np.random.default_rng(1).integers(
        0, 256, (6, 36, 48, 3), dtype=np.uint8)
    port = next(t for t in system.pipe.towers if t.name == tower)
    from v2ap_torch.models.clip_vit import device_normalize

    px = torch.from_numpy(frames)
    with torch.no_grad():
        got = port.model(device_normalize(port.preprocess(px), port.mean,
                                          port.std))
        cls, _, mean, std = reference.TOWERS[tower]
        tc = cfg["towers"][tower]
        ref_model = reference.build(cls, w["towers"][tower], tc,
                                    device="cpu")
        geom = reference.resize_center_crop(px, tc["image_size"])
        assert torch.equal(geom, port.preprocess(px))
        want = ref_model(reference.normalize(geom, mean, std))
    _close(got, want)


def test_prompt_context_agrees(mixed):
    cfg, w, system = mixed
    prompts = ["a slow piano ballad in a quiet room", "rain on a window"]
    with torch.no_grad():
        got, got_mask = system.pipe.encode_text(prompts)
    want, mask = reference.prompt_context(cfg, w, prompts, "cpu")
    assert torch.equal(got_mask, mask)
    _close(got, want)


def test_roll_and_flow_and_decoder_agree(mixed):
    cfg, w, system = mixed
    pipe = system.pipe
    rng = np.random.default_rng(2)
    strips = rng.integers(0, 256, (8, 100, 900), dtype=np.uint8)
    ref_cfm = reference.build(RefCFM, w["cfm"], cfg["model"],
                              cfg["conditioning"], device="cpu")
    n = 96
    with torch.no_grad():
        source = pipe._decode_strips(None, [], [(strips, 1.6)])
        got_roll = pipe._roll_from_strips(
            pipe._piano_strips(None, n, [], [(strips, 1.6)], source), n)
        want_roll = reference.piano_roll(ref_cfm, cfg, strips, 1.6, n, "cpu")
        _close(got_roll, want_roll)
        m = cfg["model"]
        g = torch.Generator().manual_seed(3)
        x = torch.randn(2, n, m["num_channels"], generator=g)
        text = torch.randn(2, n, m["dim_text_raw"], generator=g)
        roll = torch.rand(2, n, m["notes"], generator=g)
        ctx = torch.randn(2, 5, m["dim_context"], generator=g)
        ctx_mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]]).bool()
        mask = torch.arange(n)[None] < torch.tensor([[80], [96]])
        t = torch.tensor([0.3, 0.7])
        got = pipe.cfm.pred_head(x, None, times=t, mask=mask,
                                 text_embed=text, frames_embed=roll,
                                 context=ctx, context_mask=ctx_mask)
        want = ref_cfm.pred_head(x, t, mask, text, roll, ctx, ctx_mask)
        _close(got, want)
        lat = torch.randn(2, 60, m["num_channels"], generator=g)
        decoder = reference.build(reference.EncodecDecoder, w["decoder"],
                                  cfg["encodec"], device="cpu")
        _close(pipe.codec.decode(lat), decoder(lat))


@pytest.mark.parametrize("kind,piano", [("single", False), ("single", True),
                                        ("batch", False)])
def test_whole_calls_agree(mixed, kind, piano):
    cfg, w, system = mixed
    traffic = Traffic(tiny_traffic(kind, piano), 11)
    pool = traffic.make_pool(torch.device("cpu"))
    req = traffic.request(0, pool)
    if kind == "batch":
        got, _, _ = system.serve(req, kind, system.x0(req))
        want = reference.batch(cfg, w, req, "cpu")
    else:
        got, roll, _ = system.serve(req, kind)
        want, want_roll = reference.single(cfg, w, req, "cpu")
        want = want[None]
        if piano:
            _close(roll, want_roll)
    _close(got, want)


def test_t5_queries_are_drawn_at_t5s_scale():
    cfg = json.loads((REPO / "benchmark/configs/crossatt3.json").read_text())
    cfg["t5"].update(num_layers=1, vocab_size=64)
    cfg["towers"]["clip_vit"].update(num_layers=1)
    w = weights.make(cfg, 3, torch.device("cpu"), with_t5=True)["t5"]
    d, dkv = cfg["t5"]["d_model"], cfg["t5"]["d_kv"]
    assert w["blocks.0.attn.q.weight"].float().std().item() == \
        pytest.approx((d * dkv) ** -0.5, rel=0.02)
    assert w["blocks.0.attn.k.weight"].float().std().item() == \
        pytest.approx(d ** -0.5, rel=0.02)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=600)
    return set(out.stdout.split())


def test_a_run_loads_nothing_of_jax():
    code = ("import json, tempfile\n"
            "from pathlib import Path\n"
            "from benchmark import harness\n"
            "from benchmark.tests.tiny import make_root\n"
            "root = make_root(Path(tempfile.mkdtemp()))\n"
            "out = harness.run_cell('tiny-mixed.v2a', 5, 0.1, True, 'cpu',"
            " root)\n"
            "assert out['correct'], out\n")
    loaded = _loaded(code)
    assert "v2ap_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    loaded = _loaded("import benchmark.reference.pipeline, benchmark.counts,"
                     " benchmark.weights, benchmark.check, benchmark.traffic")
    assert not loaded & set(FORBIDDEN + ("v2ap_torch",))
