"""The port's batch evaluation and its CLIs against the JAX package's, on
the CPU: ``pipelines/batch_eval.run_batch_eval`` (the generate calls it
makes, the files and ``summary.json`` it writes, a failing clip), the
whole slice from a manifest to wavs and metrics on the tiny pipelines with
the same weights and x0, the CLAP tokenizer and filter registry, the argv
of ``inference_v2a`` / ``inference_v2p``, and ``python -m
v2ap_torch.evaluate`` end to end from primed caches.

Tolerances: the stub runs and the host code are exact; the tiny slice's
wavs within 1e-4 relative RMS of JAX's (f32 products in another order),
its Cnn14 embeddings within 1e-4 relative RMS and FAD within 1e-3
relative (a difference of nearby covariances).
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_pipeline import write_synthetic_video
from tests.test_torch_models import rel_rms
from tests.test_torch_ops import T, flatten_jax, randomize_jax
from tests.test_torch_pipeline import pipelines  # noqa: F401 (fixture)
from v2ap_torch import inference_v2a as t_v2a
from v2ap_torch import inference_v2p as t_v2p
from v2ap_torch.data import clap_filter as t_filter
from v2ap_torch.evaluation import clap_scorer as t_scorer
from v2ap_torch.pipelines import batch_eval as t_batch
from v2ap_tpu.data import clap_filter as j_filter
from v2ap_tpu.evaluation import clap_scorer as j_scorer
from v2ap_tpu.pipelines import batch_eval as j_batch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 24_000


class StubPipeline:
    """Records every ``generate`` call; a path containing "bad" raises."""

    def __init__(self):
        self.calls = []

    def generate(self, path, prompt, **kw):
        self.calls.append((path, prompt, dict(kw)))
        if "bad" in path:
            raise RuntimeError("undecodable clip")
        rng = np.random.default_rng(kw["seed"])
        return (rng.normal(size=SR // 2) * 0.1).astype(np.float32), SR


def _manifest(tmp_path, rows):
    scp = tmp_path / "eval.scp"
    scp.write_text("".join(f"{p}\t{c}\n" for p, c in rows))
    return str(scp)


def _scorer(wav, caption):
    return float(np.tanh(np.mean(wav[:1000]) * 10 + len(caption) / 100))


@pytest.fixture
def scorers():
    """The same scorer registered in both packages' filters, removed after."""
    j_filter.set_scorer(_scorer)
    t_filter.set_scorer(_scorer)
    yield
    j_filter.set_scorer(None)
    t_filter.set_scorer(None)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(start=1, end=5, step=2, caption_prefix="the sound of ", steps=7,
         cfg_strength=3.0, seed=5, passes=2),
    dict(drop_prompt=True, piano=True, clap_scores=True, mux=False),
], ids=["defaults", "sliced", "piano_clap"])
def test_run_batch_eval_matches_jax(tmp_path, scorers, kw):
    """The same generate calls, files, summary keys and values (walls
    aside); the failing clip counted and skipped in both."""
    rows = [(f"/data/v{i}.mp4" if i != 2 else "/data/bad2.mp4", f"cap {i}")
            for i in range(6)]
    scp = _manifest(tmp_path, rows)
    out = {}
    for name, mod in (("jax", j_batch), ("port", t_batch)):
        stub = StubPipeline()
        d = tmp_path / name
        out[name] = (stub.calls, mod.run_batch_eval(stub, scp, str(d), **kw),
                     {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
                      if f != "summary.json"},
                     json.loads((d / "summary.json").read_text()))
    (jc, js, jf, jj), (tc, ts, tf, tj) = out["jax"], out["port"]
    assert tc == jc and len(tc) >= 2
    assert tf == jf and tf
    timing = ("wall_seconds", "realtime_factor")
    for got, want in ((ts, js), (tj, jj)):
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if k not in timing} == \
            {k: v for k, v in want.items() if k not in timing}
    assert ts["failed"] == (1 if any("bad" in c[0] for c in tc) else 0)
    if kw.get("clap_scores"):
        assert len(ts["clap_scores"]) == ts["succeeded"]


def test_fallback_tokenize_equals_jax():
    captions = ["a dog barks", "", "Rain ON a tin roof", "ünïcödé wörds ok",
                " ".join(f"w{i}" for i in range(80))]
    for vocab in (100, 50265):
        ids_t, mask_t = t_scorer._fallback_tokenize(captions, vocab)
        ids_j, mask_j = j_scorer._fallback_tokenize(captions, vocab)
        assert ids_t.tobytes() == ids_j.tobytes()
        assert mask_t.tobytes() == mask_j.tobytes()
        assert ids_t.dtype == ids_j.dtype and mask_t.dtype == mask_j.dtype


def test_clap_filter_matches_jax(scorers):
    wav = (np.random.default_rng(1).normal(size=(1, SR)) * 0.2
           ).astype(np.float32)
    assert t_filter.has_scorer() and j_filter.has_scorer()
    assert t_filter.score(wav, SR, "a cat") == j_filter.score(wav, SR, "a cat")
    for thr in (None, -2.0, 0.0, 2.0):
        assert t_filter.passes(wav, SR, "a cat", thr) == \
            j_filter.passes(wav, SR, "a cat", thr)
    t_filter.set_scorer(None)
    j_filter.set_scorer(None)
    assert t_filter.score(wav, SR, "x") is None is j_filter.score(wav, SR, "x")
    assert t_filter.passes(wav, SR, "x", 0.5) == (None, True) == \
        j_filter.passes(wav, SR, "x", 0.5)


def test_clap_scorer_tokenizer_switch(tmp_path, monkeypatch):
    """A tokenizer path that exists raises (JAX would load a RoBERTa BPE
    tokenizer); a missing one falls back to the hash tokenizer, as in JAX."""
    from v2ap_torch.models.clap import clap_tiny_test
    a, t = clap_tiny_test()
    monkeypatch.setenv("V2AP_CLAP_TOKENIZER", str(tmp_path))
    with pytest.raises(NotImplementedError, match="tokenizer"):
        t_scorer.make_clap_scorer(a, t, device="cpu")
    monkeypatch.setenv("V2AP_CLAP_TOKENIZER", str(tmp_path / "missing"))
    scorer = t_scorer.make_clap_scorer(a, t, device="cpu")
    s = scorer(np.random.default_rng(2).normal(size=48_000) * 0.1, "a dog")
    assert -1.0 <= s <= 1.0


def test_clap_scorer_matches_jax_with_the_same_weights(tmp_path):
    """The tiny scorers of both packages from the same weights (JAX's,
    saved in the port's checkpoint layout and read through
    ``V2AP_CLAP_WEIGHTS``' path): the same score of a 48 kHz clip longer
    than the 10 s window's equivalent (cropped) and of a short one
    (resized)."""
    from flax import nnx

    from v2ap_torch.models import clap as t_clap
    from v2ap_torch.utils.checkpoint import save_model
    from v2ap_torch.utils.convert import load_jax_params
    from v2ap_tpu.models import clap as j_clap
    from v2ap_tpu.utils.jitting import create_model

    a, t = j_clap.clap_tiny_test()
    jm = create_model(lambda: j_clap.ClapModel(a, t, rngs=nnx.Rngs(0)))
    randomize_jax(jm, 3, scale=0.2)
    tm = t_clap.ClapModel(*t_clap.clap_tiny_test(), device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    save_model(str(tmp_path / "clap"), tm)
    port = t_scorer.make_clap_scorer(*t_clap.clap_tiny_test(),
                                     weights_path=str(tmp_path / "clap"),
                                     device="cpu")
    sim = nnx.jit(lambda m, f, i, k: m.similarity(f, i, k))
    rng = np.random.default_rng(4)
    for n in (48_000 * 2, 48_000 // 2):     # 201 frames > 128; 51 < 128
        wav = (rng.normal(size=n) * 0.1).astype(np.float32)
        feats = j_clap.clap_logmel(wav[None], n_mels=a.num_mel_bins)
        feats = feats[:, :, :a.spec_size * a.freq_ratio]
        ids, mask = j_scorer._fallback_tokenize(["a dog barks"],
                                                t.vocab_size)
        want = float(np.asarray(sim(jm, feats, ids, mask))[0])
        got = port(wav, "a dog barks")
        assert abs(got - want) < 1e-5, (n, got, want)


# ------------------------------------------------------- the slice as a whole

def test_batch_eval_slice_matches_jax(pipelines, tmp_path, monkeypatch):
    """A manifest of two synthetic videos through both tiny pipelines with
    the same weights (x0 from JAX's draw for each clip's seed), then the
    metrics over the written wavs with one tiny Cnn14's weights in both
    packages: wavs, embeddings, logits and the metrics agree."""
    import jax
    from flax import nnx

    from v2ap_torch.data.audio_io import read_wav
    from v2ap_torch.evaluation import metrics as t_metrics
    from v2ap_torch.evaluation import pann as t_pann
    from v2ap_torch.utils.convert import load_jax_params
    from v2ap_tpu.evaluation import metrics as j_metrics
    from v2ap_tpu.evaluation import pann as j_pann
    from v2ap_tpu.utils.jitting import create_model

    jp, tp = pipelines
    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    assert write_synthetic_video(a, frames=10, fps=10)
    assert write_synthetic_video(b, frames=6, fps=8, size=(48, 64))
    scp = _manifest(tmp_path, [(a, "rain"), (b, "a dog barks")])

    def jax_normal(seed, shape):
        return T(np.array(jax.random.normal(jax.random.key(seed), shape)))

    monkeypatch.setattr(tp, "_normal", jax_normal)
    kw = dict(steps=3, caption_prefix="the sound of ", seed=7)
    js = j_batch.run_batch_eval(jp, scp, str(tmp_path / "j"), **kw)
    ts = t_batch.run_batch_eval(tp, scp, str(tmp_path / "t"), **kw)
    assert js["succeeded"] == ts["succeeded"] == 2
    assert js["failed"] == ts["failed"] == 0
    wavs = {}
    for side in ("j", "t"):
        wavs[side] = [read_wav(str(tmp_path / side / f"{s}.wav"))[0][0]
                      for s in ("a", "b")]
    for got, want in zip(wavs["t"], wavs["j"]):
        assert got.shape == want.shape
        assert rel_rms(got, want) < 1e-4 + 2 / 32767 / np.std(want)

    cfg = j_pann.pann_tiny_test()
    jm = create_model(lambda: j_pann.Cnn14(cfg, rngs=nnx.Rngs(0)))
    randomize_jax(jm, 5, scale=0.1)
    tm = t_pann.Cnn14(t_pann.pann_tiny_test(), device="cpu").eval()
    load_jax_params(tm, flatten_jax(jm))
    # the packages' own wrappers: the host resample to 16 kHz, one forward
    joint = {"j": j_pann._wrap_forward(cfg, jm, lambda m, w: (m(w),
                                                              m.logits(w))),
             "t": t_pann._wrap_forward(t_pann.pann_tiny_test(), tm,
                                       lambda m, w: (m(w), m.logits(w)))}
    rng = np.random.default_rng(6)
    refs = [(rng.normal(size=w.shape) * 0.1).astype(np.float32)
            for w in wavs["j"]]
    emb, logit = {}, {}
    for side in ("j", "t"):
        outs = [joint[side](w, SR) for w in refs + wavs[side]]
        emb[side] = np.concatenate([e for e, _ in outs])
        logit[side] = np.concatenate([l for _, l in outs])
    assert rel_rms(emb["t"], emb["j"]) < 1e-4
    assert rel_rms(logit["t"], logit["j"]) < 1e-4
    want_m = dict(
        fad=j_metrics.fad_from_embeddings(emb["j"][:2], emb["j"][2:]),
        kl=j_metrics.kl_softmax(logit["j"][:2], logit["j"][2:]),
        is_mean=j_metrics.inception_score(logit["j"][2:])[0])
    got_m = dict(
        fad=t_metrics.fad_from_embeddings(emb["t"][:2], emb["t"][2:]),
        kl=t_metrics.kl_softmax(logit["t"][:2], logit["t"][2:]),
        is_mean=t_metrics.inception_score(logit["t"][2:])[0])
    for k in want_m:
        assert np.isfinite(got_m[k])
        assert abs(got_m[k] - want_m[k]) <= 1e-3 * abs(want_m[k]) + 1e-6, k


# ---------------------------------------------------------------------- argv

def _jax_cli():
    return importlib.import_module("inference_v2a")


def _jax_v2p_namespace(argv):
    """What JAX's ``inference_v2p.main`` runs for ``argv``."""
    parse = _jax_cli().parse_args
    argv = list(argv)
    if argv and not argv[0].startswith("-"):
        args = parse((argv + ["--piano"])[:6])
        args.piano = True
        return args
    return parse(argv + ["--piano"] if "--piano" not in argv else argv)


ARGVS = [
    ["ckpts/model", "0", "eval.scp", "0", "100", "out/"],
    ["ckpts/model", "1", "eval.scp", "3", "9", "out/", "2"],
    ["--scp", "eval.scp", "--out", "o/"],
    ["--ckpt", "c", "--drop-prompt", "--scp", "s", "--start", "1", "--end",
     "5", "--step", "2", "--raw-captions", "--out", "o", "--steps", "8",
     "--cfg", "3.5", "--seed", "4", "--piano", "--passes", "2", "--tiny"],
]


def _without_device(ns):
    d = vars(ns).copy()
    assert d.pop("device") is None
    return d


@pytest.mark.parametrize("argv", ARGVS, ids=["pos6", "pos7", "flags_min",
                                             "flags_all"])
def test_inference_argv_parses_like_jax(argv):
    assert _without_device(t_v2a.parse_args(argv)) == \
        vars(_jax_cli().parse_args(argv))
    assert _without_device(t_v2p.parse_args(argv)) == \
        vars(_jax_v2p_namespace(argv))


def test_positional_form_takes_the_port_flags_after_it():
    ns = t_v2a.parse_args(ARGVS[1] + ["--device", "cpu", "--tiny"])
    assert (ns.device, ns.tiny, ns.step, ns.out, ns.steps) == \
        ("cpu", True, 2, "out/", 64)
    ns = t_v2p.parse_args(ARGVS[1] + ["--device", "cpu", "--steps", "25"])
    assert (ns.device, ns.piano, ns.step, ns.steps) == ("cpu", True, 1, 25)


@pytest.mark.parametrize("main,argv", [
    ("v2ap_torch.inference_v2a", ["--tiny", "--scp", "S", "--out", "O"]),
    ("v2ap_torch.inference_v2p", ["c", "0", "S", "0", "1", "O"]),
    ("v2ap_torch.evaluate", ["--tiny", "--scp", "S", "--out", "O"]),
], ids=["v2a", "v2p", "evaluate"])
def test_cli_without_device_cpu_needs_cuda(main, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(main)
    argv = [str(tmp_path / a) if a in ("S", "O") else a for a in argv]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)


# ------------------------------------------------------ evaluate end to end

def test_evaluate_cli_end_to_end_from_primed_caches(tmp_path):
    """``python -m v2ap_torch.evaluate --tiny --device cpu --ref-dir
    --clap`` over two rows whose .mp4 files do not exist, their tower
    features primed beside them through the pipeline (the card's way, no
    cv2 there): every clip generated at the cached duration (so not from a
    decode), FAD / IS / KL finite with the references paired by basename,
    a CLAP score per clip; then the same rows as their own references give
    FAD and KL 0."""
    from v2ap_torch.data.audio_io import read_wav, write_wav

    pipe = t_v2a.build_pipeline(True, "cpu")
    rng = np.random.default_rng(7)
    rows, durations = [], {"c0": 2.0, "c1": 1.6}    # 150 and 120 latents
    for stem, dur in durations.items():
        path = str(tmp_path / f"{stem}.mp4")
        frames = rng.integers(0, 256, (int(dur * 5), 64, 64, 3), np.uint8)
        pipe.encode_video_frames_clip(path, 150,
                                      frames_cache=[(frames, dur, 1)])
        rows.append((path, f"caption {stem}"))
        assert not os.path.exists(path)
    del pipe
    refs = tmp_path / "refs"
    for stem, dur in durations.items():
        write_wav(str(refs / f"{stem}.wav"),
                  (rng.normal(size=int(dur * SR)) * 0.1).astype(np.float32))
    scp = _manifest(tmp_path, rows)
    env = dict(os.environ, OMP_NUM_THREADS="2")

    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "v2ap_torch.evaluate", "--tiny", "--device",
         "cpu", "--scp", scp, "--out", str(out), "--steps", "2", "--ref-dir",
         str(refs), "--clap"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads((out / "summary.json").read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == summary
    assert (summary["clips"], summary["succeeded"], summary["failed"]) == \
        (2, 2, 0)
    for stem, dur in durations.items():
        wav, sr = read_wav(str(out / f"{stem}.wav"))
        assert sr == SR and wav.shape == (1, int(dur * SR))
    for k in ("fad", "is_mean", "is_std", "kl_softmax", "kl_sigmoid",
              "realtime_factor", "metrics_seconds"):
        assert np.isfinite(summary[k]), k
    assert "fad_error" not in summary
    assert [r["clip"] for r in summary["clap_scores"]] == ["c0", "c1"]
    assert all(-1.0 <= r["clap"] <= 1.0 for r in summary["clap_scores"])
