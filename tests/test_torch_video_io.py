"""The port's conditioning plans and keyboard-strip decode
(``v2ap_torch/data/video_io.py``) against the JAX package's
(``v2ap_tpu/data/video_io.py``) on the CPU.

Tolerance: none. The plans are host numpy (integer indices and float32
weights computed by the same formulas) and the strips are uint8 from the
same cv2 calls, so every array must be equal.
"""

import numpy as np
import pytest

from v2ap_torch.data import video_io as t_video_io
from v2ap_tpu.data import video_io as j_video_io

# (num_source, duration, length): the 10 s serving clip at 25 fps (750 and
# its 768-latent bucket), a short clip, a clip shorter than its rows
PLANS = [(250, 10.0, 750), (250, 10.0, 768), (12, 1.0, 96), (7, 0.3, 40)]


@pytest.mark.parametrize("num_source,duration,length", PLANS)
def test_interp_weights_clip_matches_jax(num_source, duration, length):
    """The frame-stride blend plan: the anchors are the encoded frames."""
    for n_enc in (num_source, (num_source + 2) // 3):
        got = t_video_io.interp_weights_clip(n_enc, duration, length)
        want = j_video_io.interp_weights_clip(n_enc, duration, length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("video_multi", [3.0, 2.5], ids=["notes51", "notes88"])
@pytest.mark.parametrize("num_source,duration,length", PLANS)
def test_interp_piano_plans_match_jax(num_source, duration, length,
                                      video_multi):
    """The roll-rate strip indices, and the strided lerp plan at strip
    steps 1-3 with the full-rate count as ``num_source``."""
    np.testing.assert_array_equal(
        t_video_io.interp_indices_piano(num_source, duration, length,
                                        video_multi=video_multi),
        j_video_io.interp_indices_piano(num_source, duration, length,
                                        video_multi=video_multi))
    for step in (1, 2, 3):
        got = t_video_io.interp_weights_piano(num_source, duration, length,
                                              step, video_multi=video_multi)
        want = j_video_io.interp_weights_piano(num_source, duration, length,
                                               step, video_multi=video_multi)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        i0, i1, w = got
        assert not w[i1 == i0].any()          # coinciding anchors: w = 0


def _clip(tmp_path, cv2, n=11, size=(48, 36)):
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, size)
    rng = np.random.default_rng(12)
    for _ in range(n):
        writer.write(rng.integers(0, 256, (size[1], size[0], 3),
                                  dtype=np.uint8))
    writer.release()
    return path


def test_piano_preprocess_matches_jax():
    pytest.importorskip("cv2")
    frames = np.random.default_rng(13).integers(0, 256, (3, 40, 64, 3),
                                                dtype=np.uint8)
    got = t_video_io.piano_preprocess(frames, width=90, height=10)
    assert got.shape == (3, 10, 90) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, j_video_io.piano_preprocess(frames, width=90, height=10))


@pytest.mark.parametrize("step,strip_step", [(1, 1), (3, 1), (3, 2)])
def test_read_video_frames_and_strips_matches_jax(tmp_path, step, strip_step):
    """One decode pass: RGB at ``step``, strips at ``strip_step``, the
    duration and the full-rate frame count."""
    cv2 = pytest.importorskip("cv2")
    path = _clip(tmp_path, cv2)
    got = t_video_io.read_video_frames_and_strips(
        path, step=step, width=90, height=10, strip_step=strip_step)
    want = j_video_io.read_video_frames_and_strips(
        path, step=step, width=90, height=10, strip_step=strip_step)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:] and got[3] == 11
    assert len(got[1]) == len(range(0, 11, strip_step))
    assert t_video_io.read_video_frames_and_strips(
        str(tmp_path / "missing.mp4")) == (None, None, None, None)
