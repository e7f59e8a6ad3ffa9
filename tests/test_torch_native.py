"""The port's host library (``v2ap_torch/native``) against the JAX package's
(``v2ap_tpu/native``) on the CPU, with seeded numpy inputs.

Both libraries are built here from their own copies of the same C++ with
the same flags, so every entry point must give the same bytes: the WAV
decoder on 16-, 24- and 32-bit PCM, 32-bit float and WAVE_FORMAT_EXTENSIBLE
files, the resampler, the hop energies, the max-energy start, the gray
resize, the PIL-exact CLIP geometry and the YUV 4:2:0 pack. Through them,
``read_wav``, ``load_training_clip``, ``select_max_energy_segment``,
``pack_yuv420`` and ``preprocess_frames`` equal JAX's exactly (and the
device geometry ``resize_center_crop``), and the tiny pipeline's YUV-route
features equal JAX's with JAX's native path on, within the 1e-5 of
``tests/test_torch_pipeline.py``'s feature check (float32 towers). A build
that fails raises with the compiler's output.
"""

import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import pipelines  # noqa: F401 (fixture)
from v2ap_torch import native as t_native
from v2ap_torch.data import audio_io as t_audio
from v2ap_torch.models import clip_vit as t_clip
from v2ap_tpu import native as j_native
from v2ap_tpu.data import audio_io as j_audio
from v2ap_tpu.models import clip_vit as j_clip

torch.set_num_threads(2)


def wav_bytes(samples: np.ndarray, sr: int, fmt: int, bits: int,
              extensible: bool = False) -> bytes:
    """A RIFF WAV of (n, channels) ``samples`` already in the sample type:
    ``fmt`` 1 (PCM) or 3 (IEEE float), as a plain or an EXTENSIBLE "fmt "
    chunk."""
    ch = samples.shape[1]
    if bits == 24:
        v = samples.astype(np.int32).reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                        1).astype(np.uint8).tobytes()
    else:
        data = samples.tobytes()
    block = ch * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, ch, sr,
                       sr * block, block, bits)
    if extensible:
        guid = struct.pack("<H", fmt) + bytes.fromhex(
            "000000001000800000aa00389b71")
        head += struct.pack("<HHI", 22, bits, (1 << ch) - 1) + guid
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _signal(n: int, ch: int, seed: int) -> np.ndarray:
    """(n, ch) float64 in [-0.9, 0.9]: a tone under seeded noise whose
    loudness swells, so the max-energy window is well inside."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    env = 0.2 + 0.7 * np.exp(-((t - 0.6 * n) / (0.1 * n)) ** 2)
    x = env * (0.6 * np.sin(2 * np.pi * 441 * t / 16000)
               + 0.4 * rng.uniform(-1, 1, (n, ch)))
    return np.clip(x, -0.9, 0.9)


WAV_KINDS = {
    "pcm16": (1, 16, False), "pcm24": (1, 24, False), "pcm32": (1, 32, False),
    "float32": (3, 32, False), "float32_extensible": (3, 32, True),
    "pcm16_extensible": (1, 16, True)}


def make_wav(kind: str, n: int = 16000 * 12, ch: int = 2, sr: int = 16000,
             seed: int = 0) -> bytes:
    fmt, bits, ext = WAV_KINDS[kind]
    x = _signal(n, ch, seed)
    if fmt == 3:
        samples = x.astype(np.float32)
    else:
        samples = np.round(x * (2 ** (bits - 1) - 1)).astype(
            np.int16 if bits == 16 else np.int32)
    return wav_bytes(samples, sr, fmt, bits, ext)


# ------------------------------------------------ the library, entry by entry

@pytest.mark.parametrize("kind", sorted(WAV_KINDS) + ["pcm8", "not_riff"])
def test_wav_decode_equals_jax(kind):
    if kind == "pcm8":                       # a format neither decodes
        data = wav_bytes(np.full((100, 1), 128, np.uint8), 8000, 1, 8)
    elif kind == "not_riff":
        data = b"OggS" + bytes(100)
    else:
        data = make_wav(kind, n=4000, seed=1)
    got, want = t_native.wav_decode(data), j_native.wav_decode(data)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32 and got[1] == want[1] == 16000


def test_wav_decode_refuses_truncated_headers():
    """A "fmt " chunk cut short, or under 8 bits a sample, decodes to None
    (the JAX package's copy would read past the buffer or divide by 0)."""
    good = make_wav("pcm16", n=100)
    assert t_native.wav_decode(good[:40]) is None
    zero_bits = good[:34] + struct.pack("<H", 0) + good[36:]
    assert t_native.wav_decode(zero_bits) is None


@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (160, 147), (1, 1)])
def test_resample_poly_equals_jax(up, down):
    x = np.random.default_rng(2).normal(size=3001).astype(np.float32)
    got = t_native.resample_poly(x, up, down)
    np.testing.assert_array_equal(got, j_native.resample_poly(x, up, down))
    assert len(got) == -(-len(x) * up // down)


def test_frame_energy_equals_jax_library():
    """JAX binds no wrapper for it: its library's symbol, called directly."""
    x = np.random.default_rng(3).normal(size=320 * 50 + 7).astype(np.float32)
    got = t_native.frame_energy(x, 320)
    want = np.empty(50, np.float32)
    j_native.lib().frame_energy(x, 50, 320, want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, t_audio.frame_energy(x[None]), rtol=1e-6)


@pytest.mark.parametrize("target", [1, 60, 750, 2000])
def test_max_energy_start_equals_jax(target):
    x = _signal(320 * 1500, 1, 4)[:, 0].astype(np.float32)
    got = t_native.max_energy_start(x, 320, target)
    assert got == j_native.max_energy_start(x, 320, target)
    if target < 1500:
        assert got == t_audio.max_energy_start_plain(x[None], target)
    else:
        assert got == 0


@pytest.mark.parametrize("shape,out", [((100, 900), (100, 900)),
                                       ((37, 53), (20, 70))])
def test_gray_resize_equals_jax(shape, out):
    rgb = np.random.default_rng(5).integers(0, 256, shape + (3,), np.uint8)
    np.testing.assert_array_equal(t_native.gray_resize(rgb, *out),
                                  j_native.gray_resize(rgb, *out))


@pytest.mark.parametrize("shape,size", [
    ((3, 37, 53), 28), ((2, 101, 67), 224), ((2, 224, 224), 224),
    ((1, 720, 1280), 224), ((1, 720, 1280), 336), ((2, 300, 301), 336)])
def test_clip_preprocess_batch_equals_jax(shape, size):
    frames = np.random.default_rng(6).integers(0, 256, shape + (3,),
                                               np.uint8)
    got = t_native.clip_preprocess_batch(frames, size)
    np.testing.assert_array_equal(got,
                                  j_native.clip_preprocess_batch(frames, size))
    # the device geometry of the port, on the CPU: bit-equal
    np.testing.assert_array_equal(
        got, t_clip.resize_center_crop(torch.from_numpy(frames), size).numpy())


def test_pack_yuv420_equals_jax():
    px = np.random.default_rng(7).integers(0, 256, (5, 224, 224, 3), np.uint8)
    for a, b in zip(t_native.pack_yuv420(px), j_native.pack_yuv420(px)):
        np.testing.assert_array_equal(a, b)
    assert t_native.pack_yuv420(px[:, :, :223]) is None         # not square
    assert t_native.pack_yuv420(px[:, :223, :223]) is None      # odd
    assert t_native.clip_preprocess_batch(px[..., :2], 28) is None  # not RGB


# ------------------------------------------------------------ the callers

@pytest.mark.parametrize("kind", sorted(WAV_KINDS))
def test_read_wav_and_training_clip_equal_jax(tmp_path, kind):
    """A 12 s stereo clip at 16 kHz: the decoded samples, then the training
    clip (mono, 24 kHz, normalised, the max-energy 10 s) and the validation
    clip exactly equal JAX's; a float32 WAV decodes (``wave`` cannot)."""
    path = str(tmp_path / f"{kind}.wav")
    with open(path, "wb") as f:
        f.write(make_wav(kind))
    got, sr = t_audio.read_wav(path)
    want, want_sr = j_audio.read_wav(path)
    assert sr == want_sr == 16000 and got.shape == (2, 16000 * 12)
    np.testing.assert_array_equal(got, want)
    for val in (False, True):
        clip = t_audio.load_training_clip(path, val=val)
        assert clip is not None and clip.shape == (1, 750 * 320)
        np.testing.assert_array_equal(clip,
                                      j_audio.load_training_clip(path, val=val))


def test_read_wav_falls_back_to_wave_for_other_formats(tmp_path):
    """8-bit PCM: the library refuses it, ``wave`` reads it and the width
    is refused as in JAX's fallback."""
    path = str(tmp_path / "u8.wav")
    with open(path, "wb") as f:
        f.write(wav_bytes(np.full((100, 1), 128, np.uint8), 8000, 1, 8))
    for read in (t_audio.read_wav, j_audio.read_wav):
        with pytest.raises(ValueError, match="width 1"):
            read(path)
    assert t_audio.load_training_clip(path) is None


@pytest.mark.parametrize("frames", [500, 751, 3000])
def test_select_max_energy_segment_equals_jax(frames):
    x = _signal(320 * frames + 100, 1, 8).T.astype(np.float32)
    got = t_audio.select_max_energy_segment(x, 750)
    np.testing.assert_array_equal(got, j_audio.select_max_energy_segment(x,
                                                                         750))
    assert got.shape == (1, 750 * 320)


@pytest.mark.parametrize("shape,size", [
    ((3, 37, 53), 224), ((2, 101, 67), 336), ((1, 720, 1280), 224),
    ((1, 720, 1280), 336), ((4, 224, 224), 224)])
def test_preprocess_frames_equals_jax(shape, size):
    frames = np.random.default_rng(9).integers(0, 256, shape + (3,),
                                               np.uint8)
    got = t_clip.preprocess_frames(frames, size)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, j_clip.preprocess_frames(frames, size, normalize=False))
    np.testing.assert_array_equal(
        got, t_clip.resize_center_crop(torch.from_numpy(frames), size).numpy())
    np.testing.assert_array_equal(
        t_clip.preprocess_frames(frames, size, normalize=True),
        j_clip.preprocess_frames(frames, size))
    np.testing.assert_array_equal(
        t_clip.host_crop_to_tower(frames, size),
        t_clip.crop_to_tower(torch.from_numpy(frames), size).numpy())


def test_yuv_route_features_equal_jax(pipelines):  # noqa: F811
    """The tiny pipelines with the same weights on the YUV wire, frames of
    37x53 (the tower's geometry then runs on the host): JAX's default
    route (native geometry and pack) and the port's give the same
    features."""
    jp, tp = pipelines
    frames = np.random.default_rng(10).integers(0, 256, (12, 37, 53, 3),
                                                np.uint8)
    cache = [(frames, 1.0, 1)]
    jp._ship_yuv420, tp.ship_yuv420 = True, True
    try:
        want, _ = jp.encode_video_frames_clip("clip.mp4", 96,
                                              frames_cache=list(cache))
        got, _ = tp.encode_video_frames_clip("clip.mp4", 96,
                                             frames_cache=list(cache))
    finally:
        jp._ship_yuv420, tp.ship_yuv420 = False, False
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    rgb, _ = tp.encode_video_frames_clip("clip.mp4", 96,
                                         frames_cache=list(cache))
    assert not torch.equal(rgb, got)             # the wire's chroma loss


# ------------------------------------------------------------- the build

def test_build_names_the_library_by_its_digest(tmp_path, monkeypatch):
    """A rebuild into an empty directory gives the library the name of its
    source's, compiler's and flags' digest, and a second call reuses it."""
    lib = t_native.build_library(tmp_path)
    assert lib.name == f"libv2ap_native_{t_native._digest()[:16]}.so"
    mtime = lib.stat().st_mtime_ns
    assert t_native.build_library(tmp_path) == lib
    assert lib.stat().st_mtime_ns == mtime
    assert list(tmp_path.iterdir()) == [lib]      # no temporary left
    src = tmp_path / "changed.cpp"
    src.write_text(t_native._SOURCE.read_text() + "\n// changed\n")
    monkeypatch.setattr(t_native, "_SOURCE", src)
    assert t_native.build_library(tmp_path) != lib


def test_failed_build_raises(tmp_path, monkeypatch):
    """A bad compiler path, and a source that does not compile, raise with
    the reason; ``lib()`` raises too (no fallback behind a broken build)."""
    monkeypatch.setattr(t_native, "_CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        t_native.build_library(tmp_path)
    monkeypatch.setattr(t_native, "_CXX", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int wav_decode( {\n")
    monkeypatch.setattr(t_native, "_SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        t_native.build_library(tmp_path / "out")
    monkeypatch.setattr(t_native, "_BUILD_DIR", tmp_path / "lib")
    t_native.lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error"):
            t_native.lib()
    finally:
        monkeypatch.undo()
        t_native.lib.cache_clear()
    assert t_native.pack_yuv420(np.zeros((1, 2, 2, 3), np.uint8)) is not None


def test_concurrent_builds_do_not_clash(tmp_path):
    """Four processes building into one directory at once (xdist workers,
    torchrun ranks) each load a whole library."""
    code = ("import sys, ctypes; from pathlib import Path; "
            "from v2ap_torch import native; "
            "lib = native.build_library(Path(sys.argv[1])); "
            "ctypes.CDLL(str(lib)).pack_yuv420; print(lib.name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({out.strip() for out, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [outs[0][0].strip()]
