"""The correctness check's control, on the card at each cell's own size:
the port's own int8 path (the precision below the configurations' bf16)
must fail a limit that the configured path passes. Skips without an
NVIDIA card; on the card:

    python -m pytest benchmark/tests/test_benchmark_control.py -q
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark import check, control, harness

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_benchmark(REPO)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_configured_path_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    limits = check.load_limits(REPO, workload)
    (_, sound), = control.readings(workload, [5101], int8=False, root=REPO)
    assert check.judge(sound, limits)[0], sound
    (_, low), = control.readings(workload, [5102], int8=True, root=REPO)
    assert not check.judge(low, limits)[0], low
