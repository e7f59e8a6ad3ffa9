"""The wire-level shipping modes and the streaming decode of the port
against the JAX package's, on the CPU.

``pack_yuv420`` equals the JAX package's default (its native fixed-point
path) bit for bit, its plain version JAX's numpy path bit for bit and the
native one within 1 LSB; ``unpack_yuv420`` and
``upsample_strips_2x`` equal JAX's within 1e-6 (float32);
``pack_strips_half`` is exact. In the pipeline, ``V2AP_SHIP_YUV420=1`` and
``V2AP_SHIP_STRIP_HALF=1`` run and tag the caches as JAX's, and the
streamed features (``V2AP_STREAM_DECODE=1``) equal the decoded ones
exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline import write_synthetic_video
from v2ap_torch import config as t_config
from v2ap_torch.data import video_io as t_video_io
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.models import video2roll as t_v2r
from v2ap_tpu import native
from v2ap_tpu.data import video_io as j_video_io
from v2ap_tpu.models import clip_vit as j_clip
from v2ap_tpu.models import video2roll as j_v2r

MEAN, STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258,
                                                  0.27577711)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    smooth = np.linspace(0, 255, 28, dtype=np.float32)
    img = (smooth[None, :, None] * 0.6 + smooth[:, None, None] * 0.4
           + rng.normal(0, 3, (3, 28, 28, 3)))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_pack_yuv420_matches_jax(frames, monkeypatch):
    y, uv = t_clip.pack_yuv420(frames)
    assert y.shape == (3, 28, 28) and uv.shape == (3, 2, 14, 14)
    assert native.available()
    jy, juv = j_clip.pack_yuv420(frames)           # JAX's default: native
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    py, puv = t_clip.pack_yuv420_plain(frames)
    assert np.abs(py.astype(int) - y).max() <= 1
    assert np.abs(puv.astype(int) - uv).max() <= 1
    # the plain versions of both packages: JAX's numpy path
    monkeypatch.setattr(native, "pack_yuv420", lambda px: None)
    ny, nuv = j_clip.pack_yuv420(frames)
    np.testing.assert_array_equal(py, ny)
    np.testing.assert_array_equal(puv, nuv)


def test_unpack_yuv420_matches_jax(frames):
    y, uv = t_clip.pack_yuv420(frames)
    got = t_clip.unpack_yuv420(torch.from_numpy(y), torch.from_numpy(uv),
                               MEAN, STD).numpy()
    want = np.asarray(j_clip.unpack_yuv420(jnp.asarray(y), jnp.asarray(uv),
                                           MEAN, STD))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the round trip costs the rounding and the chroma averaging only
    rgb = (frames / 255.0 - np.asarray(MEAN)) / np.asarray(STD)
    assert np.sqrt(np.mean((got - rgb) ** 2)) / np.sqrt(np.mean(rgb ** 2)) \
        < 0.1


def test_strip_half_pack_and_upsample_match_jax():
    rng = np.random.default_rng(1)
    strips = rng.integers(0, 256, size=(4, 100, 900), dtype=np.uint8)
    half = t_video_io.pack_strips_half(strips)
    np.testing.assert_array_equal(half, j_video_io.pack_strips_half(strips))
    x = half.astype(np.float32) / 255.0
    got = t_v2r.upsample_strips_2x(torch.from_numpy(x)).numpy()
    want = np.asarray(j_v2r.upsample_strips_2x(jnp.asarray(x)))
    assert got.shape == (4, 100, 900)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _pipe(monkeypatch, **env):
    from v2ap_torch.models.clip_vit import clip_tiny_test
    from v2ap_torch.models.t5 import t5_tiny_test
    from v2ap_torch.pipelines.generate import V2APipeline

    for var in ("V2AP_SHIP_YUV420", "V2AP_SHIP_STRIP_HALF",
                "V2AP_STREAM_DECODE", "V2AP_STRIP_STRIDE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = t_config.tiny_tower_test()
    cfg = cfg.replace(conditioning=dataclasses.replace(
        cfg.conditioning, feature_cache=False, strip_stride=2))
    return V2APipeline(cfg, device="cpu", t5_config=t5_tiny_test(),
                       clip_config=clip_tiny_test(), quantize_towers=False)


def test_wire_modes_run_and_tag_caches_as_jax(monkeypatch, frames):
    """Off by default on the card (no tunnel); on, the tags are JAX's and
    strip-half forces strip stride 1; the YUV features track the RGB ones,
    the strip-half roll the exact one, both finite."""
    rgb = _pipe(monkeypatch)
    assert not rgb.ship_yuv420 and not rgb.ship_strip_half
    assert rgb.strip_stride == 2 and rgb._roll_tag == "bf16+ss2"
    wire = _pipe(monkeypatch, V2AP_SHIP_YUV420="1", V2AP_SHIP_STRIP_HALF="1")
    assert wire._tower_tag == "bf16+yuv420"
    assert wire._roll_tag == "bf16+shalf" and wire.strip_stride == 1
    assert _pipe(monkeypatch, V2AP_SHIP_YUV420="0").ship_yuv420 is False
    cache = [(frames, 1.0, 1)]
    a, _ = rgb.encode_video_frames_clip(None, 75, frames_cache=list(cache))
    b, _ = wire.encode_video_frames_clip(None, 75, frames_cache=list(cache))
    assert torch.isfinite(b).all()
    assert 0 < (b - a).norm() / a.norm() < 0.2
    strips = np.random.default_rng(2).integers(0, 256, (30, 100, 900),
                                               dtype=np.uint8)
    exact = rgb._roll_from_strips(rgb._ship_strips(strips), 72)
    shipped = wire._ship_strips(strips)
    assert tuple(shipped.shape) == (1, 30, 100, 450)
    half = wire._roll_from_strips(shipped, 72)
    assert torch.isfinite(half).all() and half.shape == exact.shape
    wav, _ = wire.generate(None, steps=2, piano=True,
                           frames_cache=list(cache),
                           strips_cache=[(strips, 1.0)])
    assert np.isfinite(wav).all()


def test_streamed_features_equal_decoded(monkeypatch, tmp_path):
    """V2AP_STREAM_DECODE=1 (chunks of 4 frames through the tower as they
    decode) gives the decoded path's features and duration exactly; the
    reader without cv2 raises naming it."""
    video = str(tmp_path / "v.mp4")
    assert write_synthetic_video(video, frames=11, fps=10)
    plain = _pipe(monkeypatch)
    want, dur = plain.encode_video_frames_clip(video, 80, chunk=4)
    stream = _pipe(monkeypatch, V2AP_STREAM_DECODE="1")
    seen = []
    real = t_video_io.VideoChunkReader

    class Recording(real):
        def __iter__(self):
            for c in super().__iter__():
                seen.append(len(c))
                yield c

    monkeypatch.setattr(t_video_io, "VideoChunkReader", Recording)
    got, dur2 = stream.encode_video_frames_clip(video, 80, chunk=4)
    assert seen == [4, 4, 3]
    assert dur2 == pytest.approx(dur)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        real(video, 4)
