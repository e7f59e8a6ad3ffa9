"""The port's small CLIs: ``python -m v2ap_torch.merge_wavs`` against the
JAX package's ``scripts/merge_wavs.py`` (the same files, sample for
sample), and the weights-day runbook's dry run (``python -m
v2ap_torch.weights_day --dry-run``) over the four reference variants."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from v2ap_torch import merge_wavs as t_merge
from v2ap_torch import weights_day
from v2ap_torch.data.audio_io import read_wav, write_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_merge_wavs", ROOT / "scripts" / "merge_wavs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("overlap_ms", [0, 100])
def test_merge_wavs_concat_matches_jax(tmp_path, overlap_ms, capsys):
    rng = np.random.default_rng(0)
    src = tmp_path / "chunks"
    src.mkdir()
    for stem in ("a", "b"):
        for i in range(3):
            write_wav(str(src / f"{stem}.{i:08d}.wav"),
                      (rng.normal(size=4000 + 500 * i) * 0.2
                       ).astype(np.float32), 16_000)
    (src / "other.wav").write_bytes(b"")           # not a chunk: ignored
    assert t_merge.collect_chunks(str(src)) == \
        _jax_script().collect_chunks(str(src))
    args = ["concat", "--in-dir", str(src), "--group", "2",
            "--overlap-ms", str(overlap_ms)]
    assert t_merge.main(args + ["--out-dir", str(tmp_path / "t")]) == 0
    assert "wrote 4 merged wavs from 2 stems" in capsys.readouterr().out
    assert _jax_script().main(args + ["--out-dir", str(tmp_path / "j")]) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "a.1.wav", "a.2.wav", "b.1.wav", "b.2.wav"]
    for name in names:
        got, sr = read_wav(str(tmp_path / "t" / name))
        want, sr_j = read_wav(str(tmp_path / "j" / name))
        assert sr == sr_j == 16_000
        np.testing.assert_array_equal(got, want)
    assert t_merge.main(["concat", "--in-dir", str(tmp_path / "t"),
                         "--out-dir", str(tmp_path / "x")]) == 1


def test_merge_wavs_mux_needs_matching_videos(tmp_path, capsys):
    write_wav(str(tmp_path / "a.wav"), np.zeros(100, np.float32), 24_000)
    assert t_merge.main(["mux", "--wav-dir", str(tmp_path), "--video-dir",
                         str(tmp_path), "--out-dir",
                         str(tmp_path / "m")]) == 1
    assert "muxed 0 videos (0 failed)" in capsys.readouterr().out


def test_weights_day_dry_run(tmp_path, capsys):
    """convert -> audit -> forward smoke -> round trip for the four
    variants, then the int8 gate and the reflow stage, all ok; crossatt6's
    FactorCL heads are reported, never a failure; the bench stage says the
    port has none yet."""
    assert weights_day.main(["--dry-run", "--workdir", str(tmp_path),
                             "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["dry_run_ok"] is True
    stages = summary["stages"]
    for variant in ("crossatt", "crossatt6", "crossatt3", "crossatt3_2"):
        st = stages[f"convert_{variant}"]
        assert st["ok"], (variant, st)
        assert st["unexpected"] == []
    assert stages["convert_crossatt6"]["aux_unconsumed"] > 0
    assert stages["distill"]["ok"], stages["distill"]
    assert stages["int8_gate"]["ok"], stages["int8_gate"]
    assert "no benchmark" in stages["bench"]["note"]
    assert (tmp_path / "ckpt_crossatt3" / "cfm" / "model.pt").exists()
    with pytest.raises(SystemExit):
        weights_day.main([])                      # nothing to convert
