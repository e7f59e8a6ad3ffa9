"""The port stands alone: it imports no JAX, no flax and nothing of the
JAX package, and its entry points refuse to run without CUDA unless asked
for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "v2ap_tpu")


def test_port_loads_no_jax_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import v2ap_torch\n"
        "for m in pkgutil.walk_packages(v2ap_torch.__path__, 'v2ap_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import v2ap_torch.pipelines.generate, v2ap_torch.training.trainer\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "v2ap_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_sources_import_no_jax(path):
    """Static check of every import statement, lazy ones included."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_pipeline_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from v2ap_torch.pipelines.generate import V2APipeline
    with pytest.raises(RuntimeError, match="CUDA"):
        V2APipeline()


def test_training_sources_are_checked():
    """The static check above covers the training slice, the backward
    kernel's wrapper, the V2P / prompt slice's models and the probe script
    (which ``test_port_loads_no_jax_modules`` also imports: its ``main`` is
    guarded)."""
    checked = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "v2ap_torch").rglob("*.py")}
    assert {"v2ap_torch/training/trainer.py",
            "v2ap_torch/training/__init__.py",
            "v2ap_torch/ops/flash_attention.py",
            "v2ap_torch/models/t5.py",
            "v2ap_torch/models/video2roll.py",
            "v2ap_torch/scripts/__init__.py",
            "v2ap_torch/scripts/probe_flash_bnhd.py"} <= checked


def test_serving_sources_are_checked():
    """The static check above and the import walk cover the batched-serving
    slice: the captured sampler's helpers, the WAV files, long video, the
    request batcher, the server and its examples, the int8 gate's reader
    and the two entry points."""
    checked = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "v2ap_torch").rglob("*.py")}
    assert {"v2ap_torch/utils/jitting.py",
            "v2ap_torch/data/audio_io.py",
            "v2ap_torch/pipelines/merge.py",
            "v2ap_torch/serving/__init__.py",
            "v2ap_torch/serving/batcher.py",
            "v2ap_torch/serving/server.py",
            "v2ap_torch/serving/examples.py",
            "v2ap_torch/evaluation/int8_gate.py",
            "v2ap_torch/predict.py",
            "v2ap_torch/app.py"} <= checked


def test_training_pipeline_sources_are_checked():
    """The static check and the import walk cover the training slice: the
    data layer, the pipeline, resilience, checkpoints, observability and
    the train entry point."""
    checked = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "v2ap_torch").rglob("*.py")}
    assert {"v2ap_torch/data/dataset.py",
            "v2ap_torch/data/manifests.py",
            "v2ap_torch/data/mixing.py",
            "v2ap_torch/training/pipeline.py",
            "v2ap_torch/training/resilience.py",
            "v2ap_torch/utils/checkpoint.py",
            "v2ap_torch/utils/observability.py",
            "v2ap_torch/train.py"} <= checked


def test_train_entry_point_parses_its_arguments():
    """``python -m v2ap_torch.train --help`` starts without JAX."""
    out = subprocess.run([sys.executable, "-m", "v2ap_torch.train", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--corpora-root" in out.stdout and "--device" in out.stdout


@pytest.mark.parametrize("module", ["v2ap_torch.app", "v2ap_torch.predict"])
def test_entry_points_parse_their_arguments(module):
    """``python -m`` on each entry point starts without JAX and prints its
    usage (importing it starts nothing: the work is under ``__main__``)."""
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--tiny" in out.stdout and "--cpu" in out.stdout


def test_preference_and_reference_sources_are_checked():
    """The static check and the import walk cover the rest of training and
    the reference layout: DPO, FactorCL, reflow distillation, the loader
    and manifests of the reference's checkpoints and the two entry points."""
    checked = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "v2ap_torch").rglob("*.py")}
    assert {"v2ap_torch/training/dpo.py",
            "v2ap_torch/training/contrastive.py",
            "v2ap_torch/training/distill.py",
            "v2ap_torch/utils/reference_ckpt.py",
            "v2ap_torch/utils/reference_manifest.py",
            "v2ap_torch/convert.py",
            "v2ap_torch/distill.py"} <= checked


@pytest.mark.parametrize("module,flag", [("v2ap_torch.distill", "--ckpt"),
                                         ("v2ap_torch.convert", "--cfm-ckpt")])
def test_conversion_and_distill_entry_points_parse_their_arguments(module,
                                                                   flag):
    """``python -m`` on each starts without JAX and prints its usage."""
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert flag in out.stdout and "--tiny" in out.stdout


def test_evaluation_sources_are_checked():
    """The static check and the import walk cover the evaluation slice:
    the log-mel ops, the metrics, PANN Cnn14, CLAP and its scorer and
    filter registry, batch evaluation and the three batch CLIs."""
    checked = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "v2ap_torch").rglob("*.py")}
    assert {"v2ap_torch/ops/melspec.py",
            "v2ap_torch/evaluation/metrics.py",
            "v2ap_torch/evaluation/pann.py",
            "v2ap_torch/evaluation/clap_scorer.py",
            "v2ap_torch/models/clap.py",
            "v2ap_torch/data/clap_filter.py",
            "v2ap_torch/pipelines/batch_eval.py",
            "v2ap_torch/inference_v2a.py",
            "v2ap_torch/inference_v2p.py",
            "v2ap_torch/evaluate.py"} <= checked


@pytest.mark.parametrize("module,flag", [
    ("v2ap_torch.inference_v2a", "--scp"),
    ("v2ap_torch.inference_v2p", "--piano"),
    ("v2ap_torch.evaluate", "--ref-dir")])
def test_batch_entry_points_parse_their_arguments(module, flag):
    """``python -m`` on each batch CLI starts without JAX and prints its
    usage, ``--device`` among the options."""
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert flag in out.stdout and "--device" in out.stdout
