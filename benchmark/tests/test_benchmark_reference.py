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

from benchmark import kept, weights
from benchmark.harness import FORBIDDEN
from benchmark.reference import pipeline as reference
from benchmark.reference.cfm import CFM as RefCFM
from benchmark.reference.nn import int8_linears, int8_quantize
from benchmark.reference.nn import int8_linear as ref_int8_linear
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


@pytest.fixture(scope="module")
def int8_tower():
    cfg = tiny_config(quantize_towers=True)
    w = weights.make(cfg, 8, torch.device("cpu"), with_t5=False)
    system = System(cfg, torch.device("cpu"))
    system.load(w)
    return cfg, w, system


def _close(a, b, tol=1e-4):
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    assert a.shape == b.shape
    assert (a - b).norm() <= tol * b.norm()


def _tower_features(cfg, w, system, tower):
    """(port, reference) features of one tower over six random frames, the
    reference's Linears in int8 where the configuration says so."""
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
        if cfg["quantize_towers"]:
            assert int8_linears(ref_model) == 6 * tc["num_layers"] + 1
        geom = reference.resize_center_crop(px, tc["image_size"])
        assert torch.equal(geom, port.preprocess(px))
        want = ref_model(reference.normalize(geom, mean, std))
    return got, want


@pytest.mark.parametrize("tower", ["clip_vit", "clip_vit2", "clip_convnext",
                                   "dinov2"])
def test_tower_features_agree(mixed, tower):
    _close(*_tower_features(*mixed, tower))


def test_int8_tower_features_agree(int8_tower):
    """Both sides compute the int8 products alike at float32 (the test
    below holds them to it exactly), but their attention and norms round
    differently in the last bit; where that moves an activation across a
    code's .5, the frame moves by about one code step (1/127.5 of a row's
    absmax). So most frames agree within 1e-4, and none by more than a few
    such steps."""
    cfg, w, system = int8_tower
    assert system.pipe.set_int8_towers(True) == 1 + 6 * \
        cfg["towers"]["clip_vit"]["num_layers"]
    got, want = _tower_features(cfg, w, system, "clip_vit")
    gaps = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    assert np.median(gaps) <= 1e-4 and max(gaps) <= 3 / 127.5, gaps


def test_the_int8_configuration_sets_bigGs_289_linears():
    cfg = json.loads((REPO / "benchmark/configs/crossatt3-int8.json")
                     .read_text())
    assert cfg["quantize_towers"] and not cfg["quantize_cfm"]
    tower = reference.TOWERS["clip_vit"][0](cfg["towers"]["clip_vit"],
                                            device="meta")
    assert int8_linears(tower) == 289


def test_int8_linear_matches_the_ports_at_float32():
    from v2ap_torch.utils.quantize import int8_linear, quantize_rows

    g = torch.Generator().manual_seed(4)
    x = torch.randn(5, 3, 40, generator=g) * 3.0
    # a row whose scale is 1 exactly, with ties at .5 (and past the clip),
    # and a row of zeros
    ties = torch.tensor([127.5, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5])
    x[0, 0, :8] = ties
    x[0, 0, 8:] = 0.25
    x[1, 2] = 0.0
    w = torch.randn(24, 40, generator=g) / 40 ** 0.5
    w[3] = 0.0
    b = torch.randn(24, generator=g) * 0.02
    codes, scale = int8_quantize(x)
    assert torch.equal(codes[0, 0, :8],
                       torch.tensor([127., 0, 2, 2, 0, -2, 4, -126]))
    assert torch.equal(codes[1, 2], torch.zeros(40))
    assert scale[0, 0].item() == 1.0
    assert scale[1, 2].item() == torch.tensor(1 / 127.5).item()
    for t in (x, w):
        port_codes, port_scale = quantize_rows(t)
        want_codes, want_scale = int8_quantize(t)
        assert torch.equal(port_codes.float(), want_codes)
        assert torch.equal(port_scale, want_scale)
    got, want = int8_linear(x, w, b), ref_int8_linear(x, w, b)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert torch.equal(ref_int8_linear(x[1, 2:], w, b)[0], b)


def test_int8_linear_in_bf16_matches_the_ports():
    """In the towers' compute dtype AQT rounds each step to bf16; the
    reference rounds alike, so the port's bf16 product matches it bit for
    bit."""
    from v2ap_torch.utils.quantize import int8_linear, quantize_rows

    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 96, generator=g) * 2.0
    x[0, :8] = torch.tensor([127.5, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5])
    x[0, 8:] = 0.25
    x[1] = 0.0
    x = x.bfloat16()
    w = (torch.randn(40, 96, generator=g) / 96 ** 0.5).bfloat16()
    b = (torch.randn(40, generator=g) * 0.02).bfloat16()
    port_codes, port_scale = quantize_rows(x)
    codes, scale = int8_quantize(x, dtype=torch.bfloat16)
    assert torch.equal(port_codes.float(), codes)
    assert torch.equal(port_scale.float(), scale)
    want = ref_int8_linear(x, w.float(), b.float(), torch.bfloat16)
    assert torch.equal(int8_linear(x, w, b).float(), want)
    # the float32 emulation of the same inputs is another product
    assert not torch.equal(ref_int8_linear(x.float(), w.float(), b.float()),
                           want)


def test_the_kept_layers_of_bigG():
    cfg = json.loads((REPO / "benchmark/configs/crossatt3-int8.json")
                     .read_text())
    tower = reference.TOWERS["clip_vit"][0](cfg["towers"]["clip_vit"],
                                            device="meta")
    assert kept.chosen(tower) == ["blocks.0.attn.q", "blocks.0.mlp.fc1",
                                  "blocks.47.mlp.fc2", "visual_projection"]
    assert kept._rows(64 * 257, "cpu").unique().numel() == kept.ROWS
    assert torch.equal(kept._rows(20, "cpu"), torch.arange(20))


def test_int8_towers_change_the_reference(int8_tower):
    cfg, w, _ = int8_tower
    frames = np.random.default_rng(3).integers(
        0, 256, (6, 36, 48, 3), dtype=np.uint8)
    int8, = reference.video_features(cfg, w, [(frames, 1.6)], 96, "cpu")
    plain, = reference.video_features(dict(cfg, quantize_towers=False), w,
                                      [(frames, 1.6)], 96, "cpu")
    assert (int8 - plain).norm() > 10 * 1e-4 * plain.norm()


def test_the_reference_refuses_an_int8_flow_model(int8_tower):
    cfg, w, _ = int8_tower
    traffic = Traffic(tiny_traffic(), 12)
    req = traffic.request(0, traffic.make_pool(torch.device("cpu")))
    with pytest.raises(ValueError, match="quantize_cfm"):
        reference.single(dict(cfg, quantize_cfm=True), w, req, "cpu")
    call = {"frames": [req["frames"]], "duration": req["duration"],
            "x0_seed": 1}
    with pytest.raises(ValueError, match="quantize_cfm"):
        reference.batch(dict(cfg, quantize_cfm=True), w, call, "cpu")


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
