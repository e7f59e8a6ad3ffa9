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
FORBIDDEN = ("jax", "jaxlib", "flax", "v2ap_tpu")


def test_port_loads_no_jax_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import v2ap_torch\n"
        "for m in pkgutil.walk_packages(v2ap_torch.__path__, 'v2ap_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import v2ap_torch.pipelines.generate\n"
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
