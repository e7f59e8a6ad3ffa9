"""The port's int8 serving numerics (``v2ap_torch/utils/quantize.py``,
``V2APipeline(quantize_towers=, quantize_cfm=)``, the int8 gate) against
the JAX package's AQT int8 (``v2ap_tpu/utils/quantize.py``) on the CPU.

The int8 ``Linear`` runs the codes and int32 sums AQT computes: the codes
equal AQT's, the bf16 output within one bf16 ulp of a jitted ``nnx.Linear``
with AQT's ``dot_general`` (bit-equal here), the float32 output within
1e-6 relative RMS (XLA keeps the dequantizing products in excess
precision). Quantizing is discontinuous: a float32 rounding difference
upstream flips a code now and then, which moves its row by one step of the
row's scale (1/127 of its absmax), and that row's error flips more codes
downstream; at the tiny widths (k = 32-64) one flip is about a third of a
row's whole int8 error. The tiny towers (one or two layers) stay within
1e-5 relative RMS of JAX's int8 towers. A whole int8 CFM flips enough to
land 6.7e-4 to 1.5e-3 from JAX's in one forward (int8 against float32:
5.1e-3 to 5.4e-3), while one scale per tensor instead of per row lands
1.0e-2 away, about twice the int8 gap. So the stated tolerance for the CFM
and Video2Roll's roll is 5e-3, each also within half the int8-vs-bf16 gap,
and the waveform of a whole generate (nearly constant at these weights)
within 1e-3. The gate's verdict against JAX's ``run_gate`` on the same
clips, x0 and injected embedder: the same keys and verdict, the FAD within
1e-3 absolute.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_pipeline import write_synthetic_video
from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from tests.test_torch_towers import _tower_pair
from tests.test_torch_video2roll import randomize_params_and_stats
from v2ap_torch import config as t_config
from v2ap_torch import int8_tower_gate as t_gate_cli
from v2ap_torch.evaluation import int8_gate as t_gate
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.models import t5 as t_t5
from v2ap_torch.ops.layers import Linear
from v2ap_torch.pipelines import generate as t_generate
from v2ap_torch.utils import quantize as t_quant
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.evaluation import int8_gate as j_gate
from v2ap_tpu.models.clip_vit import clip_tiny_test
from v2ap_tpu.models.t5 import t5_tiny_test
from v2ap_tpu.pipelines import generate as j_generate
from v2ap_tpu.utils import quantize as j_quant

torch.set_num_threads(2)

F32_REL_RMS = 1e-6
TOWER_REL_RMS = 1e-5
CFM_REL_RMS = 5e-3
SAMPLE_REL_RMS = 1e-3
FAD_ATOL = 1e-3


def _aqt_codes(x: np.ndarray, w: np.ndarray, dtype):
    """AQT's int8 codes of the activations (per row) and of the kernel
    (in, out) (per output channel), jitted as in a tower."""
    from aqt.jax.v2 import aqt_dot_general as adg
    from aqt.jax.v2 import config as aqt_config

    dg = aqt_config.dot_general_make(lhs_bits=8, rhs_bits=8)
    dg.fwd.dg_quantizer.init_calibration()
    dims = (((1,), (0,)), ((), ()))

    def quant(lhs, rhs):
        cfg = dg.fwd
        (lq, _), (rq, _) = adg.quant(lhs, rhs, None, None, cfg.dg_quantizer,
                                     cfg.lhs, cfg.rhs, dims, False)
        return lq.qvalue, rq.qvalue

    lq, rq = jax.jit(quant)(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    return np.asarray(lq), np.asarray(rq)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(2, 64, 48), (16, 40, 51), (37, 96, 51),
                                   (300, 128, 256)],
                         ids=["m2", "m16_k40_n51", "n51", "wide"])
def test_int8_linear_matches_aqt(dtype, m, k, n):
    """Codes equal AQT's; the output of ``Linear(int8)`` against
    ``nnx.Linear`` with AQT's ``dot_general`` on the same inputs, m <= 16
    and n = 51 included (the padding to ``torch._int_mm``'s shapes)."""
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[0] *= 20.0                         # a row of another scale
    x[-1] = 0.0                          # an absmax of 0
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    b = rng.normal(size=n).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    lq, rq = _aqt_codes(x, w, jdt)
    qx, _ = t_quant.quantize_rows(T(x).to(tdt))
    qw, _ = t_quant.quantize_rows(T(w.T.copy()).to(tdt))
    np.testing.assert_array_equal(N(qx), lq)
    np.testing.assert_array_equal(N(qw), rq.T)

    lin = nnx.Linear(k, n, dtype=jdt, rngs=nnx.Rngs(0))
    lin.kernel[...] = jnp.asarray(w)
    lin.bias[...] = jnp.asarray(b)
    lin.dot_general = j_quant.make_int8_dot_general()
    want = np.asarray(nnx.jit(lambda mod, v: mod(v))(lin, jnp.asarray(x)),
                      np.float32)
    tl = Linear(k, n, dtype=tdt, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(T(w.T.copy()))
        tl.bias.copy_(T(b))
    assert t_quant.quantize_linears_int8(tl) == 1 and tl.int8
    with torch.no_grad():
        got = N(tl(T(x)).float())
    if dtype == "float32":
        assert rel_rms(got, want) < F32_REL_RMS
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    np.testing.assert_array_equal(got[-1], N(tl.bias.to(tdt).float()))


def test_int8_matmul_pads_to_int_mm_shapes():
    """Every shape goes through ``torch._int_mm`` at > 16 rows and
    multiples of 8: the int32 sums equal an int64 product."""
    rng = np.random.default_rng(0)
    for m, k, n in ((1, 3, 1), (16, 8, 8), (17, 9, 51), (64, 1664, 1280)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        got = t_quant.int8_matmul(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got.long(), a.long() @ b.long().T)


@pytest.mark.parametrize("name", ["clip_vit2", "dinov2", "clip_convnext"])
def test_int8_towers_match_jax(name):
    """Tiny CLIP (quick GELU), DINOv2 and ConvNeXt towers, every ``Linear``
    int8 in both packages: the same layer count as JAX's
    ``quantize_linears_int8``, features within TOWER_REL_RMS of JAX's int8
    tower."""
    from tests.test_torch_towers import J_TOWERS

    jm, tm = _tower_pair(name, 3)
    size = J_TOWERS[name].image_size
    px = np.random.default_rng(4).normal(size=(3, size, size, 3)
                                         ).astype(np.float32)
    fwd = nnx.jit(lambda mod, v: mod(v))
    bf = np.asarray(fwd(jm, jnp.asarray(px)))
    assert (t_quant.quantize_linears_int8(tm)
            == j_quant.quantize_linears_int8(jm))
    want = np.asarray(fwd(jm, jnp.asarray(px)))
    with torch.no_grad():
        got = N(tm(T(px)))
    assert rel_rms(got, want) < TOWER_REL_RMS
    assert rel_rms(want, bf) > rel_rms(got, want)


# ------------------------------------------------------------ the pipeline

def _cfg(mod):
    """The tiny pipeline config of the serving tests (Video2Roll on, frame
    and strip stride 1, no feature caches)."""
    cfg = mod.tiny_test()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dim_text=16, dim_context=32,
                                  num_channels=8, video2roll=True),
        conditioning=dataclasses.replace(cfg.conditioning, frame_stride=1,
                                         strip_stride=1, feature_cache=False))


def _port(cfg, **kw):
    return t_generate.V2APipeline(cfg, device="cpu",
                                  t5_config=t_t5.t5_tiny_test(),
                                  clip_config=t_clip.clip_tiny_test(), **kw)


@pytest.fixture(scope="module")
def pipelines():
    """JAX's and the port's tiny pipelines, bf16 towers and CFM to start
    with, the same random weights."""
    jp = j_generate.V2APipeline(_cfg(j_config), t5_config=t5_tiny_test(),
                                clip_config=clip_tiny_test(),
                                quantize_towers=False, quantize_cfm=False)
    for i, model in enumerate((jp.cfm, jp.codec, jp.clip, jp.t5)):
        randomize_jax(model, 30 + i, scale=0.05)
    randomize_params_and_stats(jp.cfm.video2roll, 34)
    tp = _port(_cfg(t_config), quantize_towers=False, quantize_cfm=False)
    for a, b in ((tp.cfm, jp.cfm), (tp.codec, jp.codec), (tp.clip, jp.clip),
                 (tp.t5, jp.t5)):
        load_jax_params(a, flatten_jax(b))
    return jp, tp


def _jax_x0(s, shape):
    return T(np.asarray(jax.random.normal(jax.random.key(s), shape)))


def test_int8_layer_counts_match_jax(pipelines):
    """Every ``Linear`` of the CFM (Video2Roll's included) and of the tower,
    as JAX's ``quantize_linears_int8`` counts them on the same modules."""
    jp, tp = pipelines
    try:
        assert (t_quant.quantize_linears_int8(tp.cfm)
                == j_quant.quantize_linears_int8(jp.cfm) > 0)
        assert tp.set_int8_towers(True) == j_quant.quantize_linears_int8(
            jp.clip) > 0
    finally:
        t_quant.quantize_linears_int8(tp.cfm, on=False)
        tp.set_int8_towers(False)
        for model in (jp.cfm, jp.clip):
            for _, node in nnx.iter_graph(model):
                if isinstance(node, nnx.Linear):
                    node.dot_general = jax.lax.dot_general


@pytest.mark.parametrize("env,gate,int8", [
    (None, None, True), ("1", None, True), ("0", None, False),
    (None, False, False), (None, True, True), ("0", True, False)],
    ids=["default", "env_int8", "env_bf16", "gate_bf16", "gate_int8",
         "env_over_gate"])
def test_int8_default_resolution_and_tags(monkeypatch, tmp_path, env, gate,
                                          int8):
    """``quantize_towers=None``: ``V2AP_INT8_TOWERS``, else the gate file,
    else int8, as JAX resolves it; the feature-cache tags follow the towers'
    and the CFM's modes, with the strides, as JAX's tags do."""
    gate_file = tmp_path / "gate.json"
    if gate is not None:
        gate_file.write_text(json.dumps({"int8_default": gate}))
    monkeypatch.setenv("V2AP_INT8_GATE_FILE", str(gate_file))
    if env is None:
        monkeypatch.delenv("V2AP_INT8_TOWERS", raising=False)
    else:
        monkeypatch.setenv("V2AP_INT8_TOWERS", env)
    tp = _port(_cfg(t_config))
    assert tp.quantize_towers is int8 and tp.quantize_cfm is False
    assert all(m.int8 is int8 for m in tp.clip.modules()
               if isinstance(m, Linear))
    assert not any(m.int8 for m in tp.cfm.modules()
                   if isinstance(m, Linear))
    assert (tp._tower_tag, tp._roll_tag) == ("int8" if int8 else "bf16",
                                             "bf16")


def test_int8_cache_tags_follow_the_modes(monkeypatch):
    """Both int8 modes at frame stride 3 and strip stride 2 (the CFM's
    through ``V2AP_INT8_CFM=1``): every ``Linear`` of the CFM in int8, and
    the tags JAX's pipeline builds for them ("int8" for each mode, then
    "+s<frame stride>" and "+ss<strip stride>",
    ``v2ap_tpu/pipelines/generate.py:168,180,233,289``)."""
    monkeypatch.setenv("V2AP_FRAME_STRIDE", "3")
    monkeypatch.setenv("V2AP_STRIP_STRIDE", "2")
    monkeypatch.setenv("V2AP_INT8_CFM", "1")
    tp = _port(_cfg(t_config), quantize_towers=True)
    assert tp.quantize_cfm and all(m.int8 for m in tp.cfm.modules()
                                   if isinstance(m, Linear))
    assert (tp._tower_tag, tp._roll_tag) == ("int8+s3", "int8+ss2")


def _cfm_int8(jp, tp, on: bool) -> None:
    """Both pipelines' CFMs (Video2Roll included) to int8, or back."""
    t_quant.quantize_linears_int8(tp.cfm, on=on)
    if on:
        j_quant.quantize_linears_int8(jp.cfm)
        return
    for _, node in nnx.iter_graph(jp.cfm):
        if isinstance(node, nnx.Linear):
            node.dot_general = jax.lax.dot_general


def test_int8_cfm_matches_jax(pipelines):
    """``quantize_cfm``: every ``Linear`` of the CFM in int8 in both
    packages. One CFG-free ``pred_head`` on seeded latents and conditioning,
    and Video2Roll's roll from 10 keyboard strips: within CFM_REL_RMS of
    JAX's and closer to it than half the int8-vs-bf16 gap."""
    jp, tp = pipelines
    cfg = jp.cfg.model
    rng = np.random.default_rng(9)
    n, n_valid = 96, 75
    x0 = rng.normal(size=(2, n, cfg.num_channels)).astype(np.float32)
    text = rng.normal(size=(2, n, cfg.dim_text)).astype(np.float32)
    roll = rng.random((2, n, cfg.notes)).astype(np.float32)
    ctx = np.zeros((2, 1, cfg.dim_context), np.float32)
    cmask = np.ones((2, 1), bool)
    mask = np.arange(n)[None, :].repeat(2, 0) < n_valid
    times = np.asarray([0.3, 0.7], np.float32)
    strips = rng.integers(0, 256, (10, 100, 900), dtype=np.uint8)
    head = nnx.jit(lambda mod, *a: mod.pred_head(
        a[0], None, times=a[1], mask=a[2], text_embed=a[3], frames_embed=a[4],
        context=a[5], context_mask=a[6]))

    def both():
        j = (np.asarray(head(jp.cfm, x0, times, mask, text, roll, ctx, cmask)),
             np.asarray(jp._roll_from_strips(jp._ship_strips(
                 jp.encode_piano_frames("c.mp4", n, strips_cache=[
                     (strips, 0.4)])), n)))
        with torch.no_grad():
            t = (N(tp.cfm.pred_head(
                     T(x0), None, times=T(times), mask=T(mask),
                     text_embed=T(text), frames_embed=T(roll), context=T(ctx),
                     context_mask=T(cmask))),
                 N(tp._roll_from_strips(tp._ship_strips(
                     tp.encode_piano_frames("c.mp4", n, strips_cache=[
                         (strips, 0.4)])), n)))
        return j, t

    bf16, _ = both()
    _cfm_int8(jp, tp, True)
    try:
        want, got = both()
    finally:
        _cfm_int8(jp, tp, False)
    for i, (g, w, b) in enumerate(zip(got, want, bf16)):
        assert rel_rms(g, w) < CFM_REL_RMS, i
        assert rel_rms(g, w) < 0.5 * rel_rms(w, b), i


def test_int8_cfm_generate_matches_jax(pipelines, monkeypatch, tmp_path):
    """A whole V2P generate of one video (decoded by each package) with the
    int8 CFM, from JAX's x0: finite audio within SAMPLE_REL_RMS of JAX's."""
    jp, tp = pipelines
    monkeypatch.setattr(tp, "_normal", _jax_x0)
    video = str(tmp_path / "clip.mp4")
    assert write_synthetic_video(video, frames=10, fps=10)
    kw = dict(steps=3, seed=3, piano=True)
    _cfm_int8(jp, tp, True)
    try:
        want, _ = jp.generate(video, **kw)
        got, sr = tp.generate(video, **kw)
    finally:
        _cfm_int8(jp, tp, False)
    assert sr == 24_000 and got.shape == want.shape
    assert np.isfinite(got).all()
    assert rel_rms(got, want) < SAMPLE_REL_RMS


def test_run_gate_matches_jax(pipelines, monkeypatch, tmp_path):
    """The A/B through both packages' ``run_gate`` with one injected tiny
    embedder and CLAP scorer: the same verdict keys and verdict, FAD within
    FAD_ATOL, the same CLAP delta; the verdict file is written and read
    back by the pipeline's default; the towers end in int8, as JAX's do."""
    from v2ap_torch.evaluation.pann import make_embedder, pann_tiny_test

    jp, tp = pipelines
    monkeypatch.setattr(tp, "_normal", _jax_x0)
    videos = []
    for i in range(2):
        v = str(tmp_path / f"clip{i}.mp4")
        assert write_synthetic_video(v, frames=8, fps=4)
        videos.append(v)
    embedder = make_embedder(pann_tiny_test(), device="cpu")

    def clap(wav48, prompt):
        return float(np.mean(np.abs(wav48[:4800]))) + len(prompt)

    kw = dict(steps=2, seed=1, bound_fad=1e9, embedder=embedder, clap=clap)
    monkeypatch.setenv("V2AP_INT8_GATE_FILE", str(tmp_path / "j.json"))
    want = j_gate.run_gate(jp, videos, ["", "rain"], **kw)
    for _, node in nnx.iter_graph(jp.clip):         # JAX leaves them int8
        if isinstance(node, nnx.Linear):
            node.dot_general = jax.lax.dot_general
    monkeypatch.setenv("V2AP_INT8_GATE_FILE", str(tmp_path / "t.json"))
    try:
        got = t_gate.run_gate(tp, videos, ["", "rain"], **kw)
        assert tp.quantize_towers and all(
            m.int8 for m in tp.clip.modules() if isinstance(m, Linear))
    finally:
        tp.set_int8_towers(False)
    assert set(got) == set(want)
    assert got["int8_default"] is want["int8_default"] is True
    assert got["fad_int8_vs_bf16"] == pytest.approx(
        want["fad_int8_vs_bf16"], abs=FAD_ATOL)
    assert got["clap_delta"] == pytest.approx(want["clap_delta"], abs=1e-4)
    assert t_gate.read_gate_default() is True
    with open(t_gate.gate_file_path()) as f:
        assert json.load(f)["clips"] == 2
    kw["bound_fad"] = -1.0
    try:
        assert t_gate.run_gate(tp, videos, **kw)["int8_default"] is False
    finally:
        tp.set_int8_towers(False)
    monkeypatch.delenv("V2AP_INT8_TOWERS", raising=False)
    assert _port(_cfg(t_config)).quantize_towers is False
    np.testing.assert_array_equal(
        t_gate._to_48k(np.arange(5, dtype=np.float32), 24_000),
        j_gate._to_48k(np.arange(5, dtype=np.float32), 24_000))


def test_gate_cli_tiny_dry(tmp_path, monkeypatch, capsys):
    """``python -m v2ap_torch.int8_tower_gate --tiny --dry --device cpu``
    prints the verdict and writes no gate file; LFS-sized stubs are
    refused."""
    gate = tmp_path / "gate.json"
    monkeypatch.setenv("V2AP_INT8_GATE_FILE", str(gate))
    video = str(tmp_path / "clip.mp4")
    assert write_synthetic_video(video, frames=6, fps=4)
    assert t_gate_cli.main(["--videos", video, "--tiny", "--dry", "--steps",
                            "2", "--device", "cpu"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(verdict) == {"int8_default", "fad_int8_vs_bf16", "bound_fad",
                            "clap_delta", "clips", "steps", "seed", "wall_s"}
    assert verdict["clips"] == 1 and not os.path.exists(gate)
    stub = tmp_path / "stub.mp4"
    stub.write_bytes(b"x" * 100)
    with pytest.raises(SystemExit, match="no usable clips"):
        t_gate_cli.main(["--videos", str(stub), "--tiny", "--device", "cpu"])
