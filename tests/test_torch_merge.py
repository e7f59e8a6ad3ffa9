"""The port's long-video chunking, crossfade merge and WAV files against the
JAX package's: ``chunk_plan``, ``crossfade_concat`` and
``merge_wav_files`` within 1e-6, WAV files written by either package read
by the other, and ``generate_long`` over a three-chunk clip within 1e-4
rel-RMS in f32 from JAX's x0, on the tiny pipelines of
``tests/test_torch_pipeline.py``."""

import wave

import jax
import numpy as np
import pytest

from tests.test_pipeline import write_synthetic_video
from tests.test_torch_models import rel_rms
from tests.test_torch_pipeline import T, pipelines, strides  # noqa: F401
from v2ap_torch.data import audio_io as t_audio
from v2ap_torch.pipelines import merge as t_merge
from v2ap_tpu.data import audio_io as j_audio
from v2ap_tpu.pipelines import merge as j_merge


@pytest.mark.parametrize("duration,chunk,overlap", [
    (5.0, 10.0, 1.0), (10.0, 10.0, 1.0), (25.0, 10.0, 1.0),
    (37.3, 10.0, 2.5), (2.4, 1.0, 0.2), (61.0, 8.0, 0.5)])
def test_chunk_plan_matches_jax(duration, chunk, overlap):
    got = t_merge.chunk_plan(duration, chunk, overlap)
    want = j_merge.chunk_plan(duration, chunk, overlap)
    assert len(got) == len(want)
    np.testing.assert_allclose(np.array(got), np.array(want), atol=1e-6)
    assert got[0][0] == 0.0 and abs(got[-1][1] - duration) < 1e-9


@pytest.mark.parametrize("num,n,overlap", [(1, 500, 10), (2, 1000, 100),
                                           (3, 24_000, 2_400)])
def test_crossfade_concat_matches_jax(num, n, overlap):
    chunks = np.random.default_rng(num).normal(
        size=(num, n)).astype(np.float32)
    got = t_merge.crossfade_concat(chunks, overlap)
    want = j_merge.crossfade_concat(chunks, overlap)
    assert got.shape == want.shape == ((n - overlap) * (num - 1) + n,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _tone(sr, seconds, freq, amp):
    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.mark.parametrize("crossfade_s", [0.0, 0.05], ids=["concat",
                                                          "crossfade"])
def test_merge_wav_files_matches_jax(tmp_path, crossfade_s):
    sr = 24_000
    paths = []
    for i, seconds in enumerate((0.5, 0.3, 0.4)):
        p = str(tmp_path / f"part{i}.wav")
        j_audio.write_wav(p, _tone(sr, seconds, 220 * (i + 1), 0.3), sr)
        paths.append(p)
    got = t_merge.merge_wav_files(paths, str(tmp_path / "t.wav"), crossfade_s)
    want = j_merge.merge_wav_files(paths, str(tmp_path / "j.wav"),
                                   crossfade_s)
    a, sr_a = t_audio.read_wav(got)
    b, sr_b = j_audio.read_wav(want)
    assert sr_a == sr_b == sr and a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_wav_files_cross_between_packages(tmp_path):
    """Mono and stereo 16-bit files written by one package read back by the
    other, values beyond [-1, 1] clipped alike."""
    sr = 16_000
    rng = np.random.default_rng(3)
    mono = (0.6 * rng.normal(size=4_000)).astype(np.float32)
    stereo = rng.uniform(-1.2, 1.2, (2, 3_000)).astype(np.float32)
    for audio in (mono, stereo):
        for writer, reader in ((j_audio, t_audio), (t_audio, j_audio)):
            p = str(tmp_path / "x.wav")
            writer.write_wav(p, audio, sr)
            got, sr_got = reader.read_wav(p)
            want, _ = j_audio.read_wav(p)
            assert sr_got == sr and got.shape == (audio.reshape(
                -1, audio.shape[-1]).shape)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
            np.testing.assert_allclose(got, np.clip(audio.reshape(got.shape),
                                                    -1, 1), atol=2e-4)


@pytest.mark.parametrize("width", [3, 4], ids=["pcm24", "pcm32"])
def test_read_wav_wide_pcm_matches_jax(tmp_path, width):
    """24- and 32-bit PCM, which serving never writes but reads."""
    rng = np.random.default_rng(width)
    bits = 8 * width
    ints = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), 2_000,
                        dtype=np.int64)
    raw = b"".join(int(v).to_bytes(width, "little", signed=True) for v in ints)
    p = str(tmp_path / "w.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(24_000)
        w.writeframes(raw)
    got, sr = t_audio.read_wav(p)
    want, _ = j_audio.read_wav(p)
    assert sr == 24_000 and got.shape == want.shape == (2, 1_000)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --------------------------------------------------------------- long video

@pytest.mark.parametrize("prompt", ["", "waves on a beach"],
                         ids=["no_prompt", "prompt"])
def test_generate_long_matches_jax(pipelines, tmp_path, monkeypatch,  # noqa: F811
                                   prompt):
    """A 2.4 s clip in 1 s chunks overlapping 0.2 s: three chunks through
    one batched sampler call, from JAX's x0, within 1e-4 rel-RMS of JAX's
    generate_long."""
    jp, tp = pipelines
    path = str(tmp_path / "long.mp4")
    assert write_synthetic_video(path, frames=24, fps=10)
    seed = 6
    calls = []

    def jax_x0(s, shape):
        calls.append(shape)
        assert s == seed
        return T(np.array(jax.random.normal(jax.random.key(seed), shape)))

    monkeypatch.setattr(tp, "_normal", jax_x0)
    kw = dict(chunk_s=1.0, overlap_s=0.2, steps=3, seed=seed)
    with strides(jp, tp, frame=1):
        want, sr_j = j_merge.generate_long(jp, path, prompt, **kw)
        got, sr_t = t_merge.generate_long(tp, path, prompt, **kw)
    assert calls == [(3, 96, jp.cfg.model.num_channels)]   # one batch of 3
    assert sr_j == sr_t == 24_000
    assert got.shape == want.shape == (57_600,)
    assert rel_rms(got, want) < 1e-4


def test_generate_long_from_decoded_frames(pipelines):  # noqa: F811
    """The same route with the frames handed in decoded (the card has no
    cv2): one chunk for a clip shorter than chunk_s, three for a longer
    one, finite audio of the clip's length."""
    _, tp = pipelines
    frames = np.random.default_rng(7).integers(0, 256, (30, 28, 28, 3),
                                               dtype=np.uint8)
    short, sr = t_merge.generate_long(tp, None, chunk_s=2.0, steps=2,
                                      frames_cache=[(frames, 1.5, 1)])
    long, _ = t_merge.generate_long(tp, None, chunk_s=1.0, overlap_s=0.2,
                                    steps=2, frames_cache=[(frames, 2.4, 1)])
    assert sr == 24_000 and short.shape == (36_000,) and long.shape == (57_600,)
    assert np.isfinite(short).all() and np.isfinite(long).all()
