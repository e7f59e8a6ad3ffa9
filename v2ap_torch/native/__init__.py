"""ctypes bindings of the port's host library, ``v2ap_native.cpp``.

Counterpart of ``v2ap_tpu/native/__init__.py``, with the same entry points
and wrappers. The library is built with g++ and the JAX package's flags
(``-O3 -shared -fPIC -std=c++17``: no ``-march=native``, no fast-math, so
both packages' libraries give the same bytes) at first use, into
``build/v2ap_torch/`` beside the CUDA kernels. Its name carries the digest
of the source, the compiler and the flags, and it is written through a
temporary file and ``os.replace``, so processes that build it at once do not
clash.

Unlike the JAX package, a missing compiler or a failed build raises with
the compiler's output: there is no silent numpy fallback behind a broken
build. The fallbacks that depend on the input stay, because they define the
result: ``pack_yuv420`` and ``clip_preprocess_batch`` return None for inputs
the C++ does not take, and ``wav_decode`` returns None for a WAV format it
does not know (``data.audio_io.read_wav`` then reads it with ``wave``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().with_name("v2ap_native.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "v2ap_torch"
_CXX = "g++"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _digest() -> str:
    """The hash that names the library: its source, compiler and flags."""
    return hashlib.sha256(_SOURCE.read_bytes() + " ".join(
        (_CXX,) + _CXX_FLAGS).encode()).hexdigest()


def build_library(build_dir: Optional[Path] = None) -> Path:
    """Compile ``v2ap_native.cpp`` into ``build_dir`` (default
    ``build/v2ap_torch/``) unless a library of the same source, compiler and
    flags is there already. Returns its path; raises ``RuntimeError`` with
    the compiler's output when the build fails."""
    build_dir = Path(build_dir or _BUILD_DIR)
    lib = build_dir / f"libv2ap_native_{_digest()[:16]}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_CXX, *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as exc:
        raise RuntimeError(f"cannot run {_CXX!r} to build the host library "
                           f"(a C++17 compiler is needed): {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises if it cannot be
    built."""
    L = ctypes.CDLL(str(build_library()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {
        "wav_decode": (ctypes.c_int, [
            u8p, i64, ctypes.POINTER(i32), ctypes.POINTER(i32),
            ctypes.POINTER(i64), ctypes.c_void_p, i64]),
        "resample_poly": (i64, [f32p, i64, i32, i32, i32, f32p, i64]),
        "frame_energy": (None, [f32p, i64, i32, f32p]),
        "max_energy_start": (i64, [f32p, i64, i32, i64]),
        "gray_resize": (None, [u8p, i32, i32, i32, i32, f32p]),
        "clip_preprocess_batch": (None, [u8p, i32, i32, i32, i32, u8p]),
        "pack_yuv420": (None, [u8p, i32, i32, u8p, u8p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(L, name)
        fn.restype, fn.argtypes = restype, argtypes
    return L


# ---------------------------------------------------------------- wrappers

def wav_decode(data: bytes):
    """WAV file bytes -> (float32 (channels, n), sample rate), or None for a
    file the decoder does not take (not RIFF/WAVE, or a format other than
    16-, 24- or 32-bit PCM and 32-bit float)."""
    L = lib()
    buf = np.frombuffer(data, np.uint8)
    sr, ch, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    args = (buf, len(buf), ctypes.byref(sr), ctypes.byref(ch),
            ctypes.byref(frames))
    if L.wav_decode(*args, None, 0) != 0:
        return None
    out = np.empty(frames.value * ch.value, np.float32)
    if L.wav_decode(*args, out.ctypes.data_as(ctypes.c_void_p),
                    out.size) != 0:
        return None
    return out.reshape(frames.value, ch.value).T.copy(), int(sr.value)


def _mono(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D signal, got shape {x.shape}")
    return x


def resample_poly(x: np.ndarray, up: int, down: int,
                  half_taps: int = 32) -> Optional[np.ndarray]:
    """(n,) float32 at rate up/down by the windowed-sinc polyphase filter:
    ceil(n * up / down) samples."""
    x = _mono(x)
    if min(up, down, half_taps) < 1:
        raise ValueError(f"up {up}, down {down}, half_taps {half_taps}")
    out = np.empty((len(x) * up + down - 1) // down, np.float32)
    n = lib().resample_poly(x, len(x), up, down, half_taps, out, len(out))
    return None if n < 0 else out[:n]


def frame_energy(x: np.ndarray, hop: int) -> np.ndarray:
    """(n,) -> the mean |x| of each whole hop, (n // hop,) float32."""
    x = _mono(x)
    out = np.empty(len(x) // hop, np.float32)
    lib().frame_energy(x, len(out), hop, out)
    return out


def max_energy_start(x: np.ndarray, hop: int, target_frames: int) -> int:
    """The start, in hops, of the ``target_frames``-hop window of the largest
    summed hop energy (the first on a tie; 0 when the signal is no longer)."""
    x = _mono(x)
    return int(lib().max_energy_start(x, len(x) // hop, hop, target_frames))


def gray_resize(rgb: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 RGB (h, w, 3) -> BT.601 grayscale, bilinear-resized to float32
    (out_h, out_w) in [0, 1]."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 (h, w, 3), got {rgb.shape}")
    h, w, _ = rgb.shape
    out = np.empty((out_h, out_w), np.float32)
    lib().gray_resize(rgb, h, w, out_h, out_w, out)
    return out


def pack_yuv420(px: np.ndarray):
    """uint8 RGB (t, s, s, 3), s even -> (y (t, s, s), uv (t, 2, s/2, s/2))
    uint8: full-range BT.601, chroma 2x2 box-averaged, in fixed point (within
    1 LSB of the float path). None for other shapes."""
    px = np.ascontiguousarray(px, np.uint8)
    if px.ndim != 4:
        return None
    t, s, s2, c = px.shape
    if c != 3 or s != s2 or s % 2:
        return None
    y = np.empty((t, s, s), np.uint8)
    uv = np.empty((t, 2, s // 2, s // 2), np.uint8)
    lib().pack_yuv420(px, t, s, y, uv)
    return y, uv


def clip_preprocess_batch(frames: np.ndarray, size: int
                          ) -> Optional[np.ndarray]:
    """uint8 RGB (t, h, w, 3) -> the shortest edge resized to ``size``
    (PIL's antialiased bicubic in its fixed point, bit-equal to PIL) and
    the center ``size`` x ``size`` crop, uint8 (t, size, size, 3). None for
    frames that are not RGB or are empty."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4:
        return None
    t, h, w, c = frames.shape
    if c != 3 or min(h, w) < 1 or size < 1:
        return None
    out = np.empty((t, size, size, 3), np.uint8)
    lib().clip_preprocess_batch(frames, t, h, w, size, out)
    return out
