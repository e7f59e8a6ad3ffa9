"""The readers of the pipeline's spans and counters on a synthetic run:
the stage medians over the window's calls only, the set-up numbers from
the window's first call, and nothing (no raise) where the program reports
none of them, as a program without the spans does.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
READS = {"upload_s.single": "upload_s", "upload_s.batch": "upload_s",
         "strips_s.single": "strips_s",
         "video_encode_s.batch": "video_encode_s",
         "host_syncs.single": "host_syncs", "host_syncs.batch": "host_syncs"}


def _run(timings: list, traced: int = 0) -> harness.Run:
    cell = harness.cell("crossatt3.v2p-single", REPO)
    recs = [harness.Record(i, {}, 0.7, 1, t, np.zeros(1), None,
                           traced=i >= len(timings) - traced)
            for i, t in enumerate(timings)]
    return harness.Run(cell, window_s=10.0, records=recs)


def _timings(k: int) -> dict:
    return {"upload_s": 0.02 + k, "strips_s": 0.01 + k,
            "video_encode_s": 0.2 + k, "host_syncs": 12 + k,
            "since_init": {"init_s": 1.5 + k, "capture_s": 6.0 + k}}


@pytest.mark.parametrize("name", sorted(READS))
def test_stage_readers_take_the_windows_median(name):
    """The median over the window's calls; the traced calls after the
    window do not count."""
    run = _run([_timings(k) for k in (0, 2, 1, 50)], traced=1)
    assert harness.reader(name, REPO)(run) == pytest.approx(
        _timings(1)[READS[name]])


@pytest.mark.parametrize("name,key", [("init_s.setup", "init_s"),
                                      ("capture_s.setup", "capture_s")])
def test_setup_readers_take_the_first_window_call(name, key):
    run = _run([_timings(k) for k in (3, 0, 1)])
    assert harness.reader(name, REPO)(run) == _timings(3)["since_init"][key]


@pytest.mark.parametrize("name", sorted(READS) + ["init_s.setup",
                                                  "capture_s.setup"])
def test_readers_find_nothing_in_a_program_without_spans(name):
    """The stage keys a program without the spans reports, and a run that
    completed no call: None, no raise."""
    old = {"video_encode_s": 0.2, "conditioning_s": 0.05, "sample_s": 0.44,
           "decode_s": 0.02}
    read = harness.reader(name, REPO)
    if name != "video_encode_s.batch":
        assert read(_run([dict(old), dict(old)])) is None
    assert read(_run([])) is None
