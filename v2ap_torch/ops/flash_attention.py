"""Flash-attention forward: the plain PyTorch version and the wrappers over
the hand-written CUDA kernel in ``v2ap_torch/csrc/flash_fwd.cu``.

Counterpart of ``v2ap_tpu/ops/flash_attention.py``. Two entry points keep
the JAX signatures:

  * ``flash_attention_packed`` (K1) on head-packed (b, n, h*d) q/k/v — every
    attention of the CFM transformer;
  * ``flash_attention`` (K2) on (b, h, n, d) — the CLIP ViT-bigG tower.

On a CPU tensor each takes the plain version (``attention_reference``). On a
CUDA tensor it launches the kernel or raises; there is no fallback. Unlike
the Pallas kernels the CUDA kernel takes any sequence lengths (it masks the
ragged edges itself) and any strides with a contiguous last dim, so the
serving bucket's 800 tokens, CLIP's 257 and a length-1 cross-attention
context all run on it. ``launch_counts`` counts kernel launches per entry
point.

The kernel is compiled with nvcc for sm_90a at first use into
``build/v2ap_torch/`` (named by the source's hash, so an edited source is
rebuilt) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

NEG_INF = -1e30

launch_counts = {"flash_attention": 0, "flash_attention_packed": 0}

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "flash_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "v2ap_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
_HEAD_DIMS = (64, 104)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# --------------------------------------------------------------------------- #
# Plain version — the CPU path and the kernel's oracle
# --------------------------------------------------------------------------- #

def attention_reference(
    q: torch.Tensor,                       # (b, h, nq, d)
    k: torch.Tensor,                       # (b, h, nk, d)
    v: torch.Tensor,                       # (b, h, nk, d)
    kv_mask: torch.Tensor | None = None,   # (b, nk) True == attend
    softclamp: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if softclamp is not None:
        s = torch.tanh(s / softclamp) * softclamp
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _heads_view(t: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """(b, n, h*d) -> (b, h, n, d) view (no copy)."""
    return t.unflatten(-1, (heads, dim_head)).transpose(1, 2)


# --------------------------------------------------------------------------- #
# CUDA kernel: build, load, launch
# --------------------------------------------------------------------------- #

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the flash-attention kernel is "
                           "compiled at first use and needs the CUDA toolkit")
    return path


def build_library() -> Path:
    """Compile ``flash_fwd.cu`` unless a library built from the same source
    and flags exists; return its path."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"libflash_fwd_{digest[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.v2ap_flash_fwd.argtypes = (
        [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32]
        + [i64] * 13 + [f32, f32, ptr])
    lib.v2ap_flash_fwd.restype = i32
    lib.v2ap_cuda_error_string.argtypes = [i32]
    lib.v2ap_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, kv_mask, out, *, scale: float,
            softclamp: float | None) -> None:
    """Run the kernel on (b, h, n, d) views with contiguous last dims,
    writing into the (b, h, nq, d) view ``out``."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims {_HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, h, nk, d) or v.shape != (b, h, nk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if nq == 0 or nk == 0:
        raise ValueError("flash kernel needs nonempty q and k/v")
    devices = {t.device for t in (q, k, v, out)}
    if len(devices) != 1:
        raise ValueError(f"q/k/v/out on different devices: {devices}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"{t.stride()}")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, nk):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, nk)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.bool).contiguous()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.v2ap_flash_fwd(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None,
            out.data_ptr(), b, h, nq, nk,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            kv_mask.stride(0) if kv_mask is not None else 0,
            float(scale), float(softclamp) if softclamp is not None else 0.0,
            stream)
    if err == -1:
        raise ValueError(f"flash kernel has no build for {q.dtype}, d={d}")
    if err != 0:
        msg = lib.v2ap_cuda_error_string(err).decode()
        raise RuntimeError(f"flash kernel launch failed: {msg} ({err})")


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #

def flash_attention(
    q: torch.Tensor,                       # (b, h, nq, d)
    k: torch.Tensor,                       # (b, h, nk, d)
    v: torch.Tensor,                       # (b, h, nk, d)
    kv_mask: torch.Tensor | None = None,   # (b, nk)
    *,
    softclamp: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention on (b, h, n, d) tensors (K2). Returns (b, h, nq, d); on
    CUDA the result is a (b, h, nq, d) view of a (b, nq, h, d) buffer, so
    merging the heads back afterwards costs no copy."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_reference(q, k, v, kv_mask, softclamp=softclamp,
                                   scale=scale)
    b, h, nq, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    _launch(q, k, v, kv_mask, out, scale=scale, softclamp=softclamp)
    launch_counts["flash_attention"] += 1
    return out


def flash_attention_packed(
    q: torch.Tensor,                       # (b, nq, h*d) packed heads
    k: torch.Tensor,                       # (b, nk, h*d)
    v: torch.Tensor,                       # (b, nk, h*d)
    kv_mask: torch.Tensor | None = None,   # (b, nk)
    *,
    heads: int,
    dim_head: int,
    softclamp: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention on head-packed (b, n, h*d) tensors (K1), e.g. the three
    slices of a fused qkv projection, without materialising head
    transposes. Returns (b, nq, h*d)."""
    scale = scale if scale is not None else dim_head ** -0.5
    qh, kh, vh = (_heads_view(t, heads, dim_head) for t in (q, k, v))
    if not q.is_cuda:
        out = attention_reference(qh, kh, vh, kv_mask, softclamp=softclamp,
                                  scale=scale)
        return out.transpose(1, 2).flatten(2)
    b, nq, _ = q.shape
    out = torch.empty((b, nq, heads * dim_head), dtype=q.dtype,
                      device=q.device)
    _launch(qh, kh, vh, kv_mask, _heads_view(out, heads, dim_head),
            scale=scale, softclamp=softclamp)
    launch_counts["flash_attention_packed"] += 1
    return out
