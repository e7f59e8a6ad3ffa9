"""Flash attention: the plain PyTorch versions and the wrappers over the
hand-written CUDA kernels in ``v2ap_torch/csrc/``: on the tensor cores for
bf16 (wgmma on TMA-fed tiles: the forward ``flash_fwd_sm90.cu``, the
backward ``flash_bwd_sm90.cu``) and on the CUDA cores for f32
(``flash_fwd.cu``, ``flash_bwd.cu``).

Counterpart of ``v2ap_tpu/ops/flash_attention.py``. Two entry points keep
the JAX signatures:

  * ``flash_attention_packed`` on head-packed (b, n, h*d) q/k/v — every
    attention of the CFM transformer;
  * ``flash_attention`` on (b, h, n, d) — the CLIP ViT-bigG tower.

Without autograd (serving) each launches the forward kernel: K1 for the
packed layout, K2 for the 4D one. ``launch_plan`` (forward) and
``bwd_launch_plan`` (backward) pick the kernel by dtype (bf16: the
tensor-core kernel, f32: the CUDA-core one) and check what the tensor-core
kernels' TMA loads need (16-byte aligned bases and strides); a view that
fails raises ValueError, it is not copied. Under
autograd (an input requires grad) each goes through ``_FlashAttentionFn``,
the counterpart of ``_packed_ad`` / ``_flash_ad``: the forward launches K3
(the same kernel, also storing the per-row log-sum-exp) and saves (q, k,
v, mask, out, lse); the backward computes D = rowsum(dO * O) in plain
PyTorch, as JAX does outside its kernels, then launches K4 (dq) and K5
(dk, dv), which recompute the probabilities from lse and give masked keys
exactly zero probability.

On a CPU tensor every path takes the plain version (``attention_reference``,
``attention_fwd_lse_reference``, ``attention_bwd_reference``). On a CUDA
tensor it launches the kernel or raises; there is no fallback. Unlike the
Pallas kernels the CUDA kernels take any sequence lengths (they mask the
ragged edges themselves) and any strides with a contiguous last dim, so the
serving bucket's 800 tokens, CLIP's 257, the 782 tokens of a training
window and a short cross-attention context all run on them.
``launch_counts`` counts kernel launches by kernel. A call made while its
stream is being captured into a CUDA graph launches nothing: it is counted
into the capture's tally (``recording_launches``), which
``utils.jitting.CapturedPrograms`` keeps with the graph and adds at each
replay (``add_launches``), so the counters hold what the graphs launch too.

The kernels are compiled with nvcc for sm_90a at first use into one
library in ``build/v2ap_torch/`` (named by the sources' hash, so an edited
source is rebuilt) and loaded with ctypes.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

NEG_INF = -1e30

# K1 flash_attention_packed, K2 flash_attention, K3 flash_attention_lse,
# K4 flash_attention_bwd_dq, K5 flash_attention_bwd_dkv, P1 flash_bnhd (the
# packed-layout probe, v2ap_torch/scripts/probe_flash_bnhd.py); N1 rms_norm
# and N2 gated_residual (ops/norms.py), Q1 int8_quantize and Q2
# int8_dequantize (utils/quantize.py), built into the same library
launch_counts = {"flash_attention": 0, "flash_attention_packed": 0,
                 "flash_attention_lse": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0, "flash_bnhd": 0,
                 "rms_norm": 0, "gated_residual": 0,
                 "int8_quantize": 0, "int8_dequantize": 0}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = (_CSRC / "flash_fwd_sm90.cu", _CSRC / "flash_bwd_sm90.cu",
            _CSRC / "flash_fwd.cu", _CSRC / "flash_bwd.cu",
            _CSRC / "norms.cu", _CSRC / "quantize.cu")
# included by the sources (the tensor-core kernels; the norms and the int8
# quantize): part of the library's hash
_HEADERS = (_CSRC / "sm90_common.cuh", _CSRC / "vec16.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "v2ap_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-Xcompiler", "-fPIC")
_HEAD_DIMS = (16, 32, 64, 104)
_DTYPES = (torch.float32, torch.bfloat16)
_BOX_COLS = 64      # bf16 columns of one TMA box: 128 bytes, the swizzle span
_TMA_BYTES = 16     # TMA's granule for base addresses and strides


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# the tally of the graph this thread is capturing (``recording_launches``)
_capturing = threading.local()


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel; while the current stream is being
    captured the call only records the kernel into a graph, and counts
    into the capture's tally instead."""
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[name] += 1
    else:
        launch_counts[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Yields a ``Counter`` of the kernels recorded into a graph captured by
    this thread inside the block: what each replay of the graph launches."""
    outer = getattr(_capturing, "tally", None)
    tally = _capturing.tally = collections.Counter()
    try:
        yield tally
    finally:
        _capturing.tally = outer


def add_launches(tally) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``tally``."""
    for name, n in tally.items():
        launch_counts[name] += n


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


def _logits(q, k, softclamp, scale):
    """Softclamped logits in f32 and the softclamp's chain-rule factor
    d(clamped)/d(raw) = 1 - (clamped/c)^2 (None without softclamp)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if softclamp is None:
        return s, None
    s = torch.tanh(s / softclamp) * softclamp
    return s, 1.0 - (s / softclamp) ** 2


def attention_fwd_lse_reference(
    q: torch.Tensor,                       # (b, h, nq, d)
    k: torch.Tensor,                       # (b, h, nk, d)
    v: torch.Tensor,                       # (b, h, nk, d)
    kv_mask: torch.Tensor | None = None,   # (b, nk) True == attend
    softclamp: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's function: ``attention_reference``'s output and the f32 (b, h, nq)
    log-sum-exp of the masked logits (-1e30 where masked)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s, _ = _logits(q, k, softclamp, scale)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       v.float())
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_bwd_reference(
    q: torch.Tensor,                       # (b, h, nq, d)
    k: torch.Tensor,                       # (b, h, nk, d)
    v: torch.Tensor,                       # (b, h, nk, d)
    kv_mask: torch.Tensor | None,          # (b, nk) True == attend
    lse: torch.Tensor,                     # (b, h, nq) f32, from the forward
    delta: torch.Tensor,                   # (b, h, nq) f32, rowsum(dO * O)
    dout: torch.Tensor,                    # (b, h, nq, d)
    softclamp: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's and K5's function, ``_recompute_p``'s formulas: p = exp(s_c -
    lse) with masked p forced to 0 (so a fully masked batch element gets
    exactly zero gradient), ds = p (dp - D) (1 - (s_c/c)^2), dq = scale ds k,
    dk = ds^T (q scale), dv = p^T dO. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s, deriv = _logits(q, k, softclamp, scale)
    p = torch.exp(s - lse[..., None])
    if kv_mask is not None:
        p = p.masked_fill(~kv_mask.bool()[:, None, None, :], 0.0)
    dout = dout.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v.float())
    ds = p * (dp - delta[..., None])
    if deriv is not None:
        ds = ds * deriv
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float() * scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _run_all(cmds: list) -> None:
    """Run the commands side by side; raise with the stderr of each that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{err}")
    if failed:
        raise RuntimeError("nvcc failed on\n" + "\n".join(failed))


def _library_digest() -> str:
    """The hash that names the library: every source and header it is built
    from, and the flags."""
    return hashlib.sha256(b"".join(path.read_bytes()
                                   for path in _SOURCES + _HEADERS)
                          + " ".join(_NVCC_FLAGS).encode()).hexdigest()


def build_library() -> Path:
    """Compile the kernel sources into one library, unless a library of the
    same sources, headers and flags is built already: one nvcc per source,
    all started together, then one link. Returns the library's path."""
    digest = _library_digest()
    lib = _BUILD_DIR / f"libflash_{digest[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest[:16]}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{src.stem}_{tag}.o" for src in _SOURCES]
    _run_all([[_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_SOURCES, objs)])
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    _run_all([[_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


def _c_argtypes() -> dict:
    """The argument types of the library's kernel entry points, each of
    which returns an int; the f32 and bf16 routes of a direction share one
    parameter list. N1 and N2 are ``ops/norms.py``'s, Q1 and Q2
    ``utils/quantize.py``'s."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    fwd = [i32] + [ptr] * 6 + [i32] * 4 + [i64] * 13 + [f32, f32, ptr]
    bwd = ([i32] * 2 + [ptr] * 9 + [i32] * 4
           + [ctypes.POINTER(i64), f32, f32, ptr])
    return {"v2ap_flash_fwd": fwd, "v2ap_flash_fwd_sm90": fwd,
            "v2ap_flash_bwd": bwd, "v2ap_flash_bwd_sm90": bwd,
            "v2ap_rms_norm": ([i32] + [ptr] * 3 + [i64] * 5
                              + [i32, i32, f32, f32, ptr]),
            "v2ap_gated_residual": [i32] + [ptr] * 4 + [i64] * 7 + [i32, ptr],
            "v2ap_int8_quantize": ([i32] * 2 + [ptr] * 3 + [i64] * 4
                                   + [i32, i32, ptr]),
            "v2ap_int8_dequantize": ([i32] * 2 + [ptr] * 5 + [i64] * 3
                                     + [i32, ptr])}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    for name, types in _c_argtypes().items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    lib.v2ap_cuda_error_string.argtypes = [ctypes.c_int]
    lib.v2ap_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_launch_error(err: int, what: str) -> None:
    """Raise if an entry point of the library returned a CUDA error (the
    norms' and the int8 kernels' convention: 0 on success)."""
    if err != 0:
        text = _library().v2ap_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {text} ({err})")


def _check(q, k, v, kv_mask, others) -> torch.Tensor | None:
    """Validate (b, h, n, d) views for the kernels; return the mask as a
    contiguous bool (b, nk) tensor on q's device, or None."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.dtype not in _DTYPES:
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
    named = {"q": q, "k": k, "v": v, **others}
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"q/k/v and outputs on different devices: {devices}")
    for name, t in named.items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"{t.stride()}")
    if kv_mask is None:
        return None
    if tuple(kv_mask.shape) != (b, nk):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, nk)}")
    return kv_mask.to(device=q.device, dtype=torch.bool).contiguous()


def _raise_on(err: int, lib, what: str, q) -> None:
    if err == -1:
        raise ValueError(f"{what} has no build for {q.dtype}, d={q.shape[-1]}")
    if err == -999:
        raise RuntimeError(f"{what}: libcuda offers no cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed (CUresult "
                           f"{-1000 - err})")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.v2ap_cuda_error_string(err).decode()} "
                           f"({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class LaunchPlan(NamedTuple):
    """How ``_launch`` runs one forward call, or ``_launch_bwd`` one
    backward call."""
    route: str          # "wgmma" (bf16: flash_fwd_sm90.cu, flash_bwd_sm90.cu)
                        # or "cuda_core" (f32: flash_fwd.cu, flash_bwd.cu)
    head_dim: int
    padded_dim: int     # the head dim the wgmma tiles span, zero past head_dim
    box_cols: int       # columns of one TMA box (0: no TMA)
    strides: tuple      # (b, h, n) element strides: forward q, k, v, out;
                        # backward q, k, v, dout, then two gradients (dq and
                        # zeros, or dk and dv)


def _tma_strides(t: torch.Tensor, name: str) -> tuple:
    """(b, h, n) strides of a bf16 (b, h, n, d) view for its TMA tensor map.
    TMA takes a 16-byte aligned base and strides that are multiples of 16
    bytes; a dim of size 1 is never stepped, so a stride TMA would refuse
    there becomes one granule."""
    sb, sh, sn = t.stride()[:3]
    ptr = t.data_ptr()
    if sb > 0 and sh > 0 and sn > 0 and \
            not (ptr | 2 * (sb | sh | sn)) % _TMA_BYTES:
        return sb, sh, sn                             # the common case
    if ptr % _TMA_BYTES:
        raise ValueError(f"{name}: the tensor-core kernel loads with TMA, which "
                         f"needs a 16-byte aligned base; this view starts "
                         f"{ptr % _TMA_BYTES} bytes past one")
    out = []
    for n, st in zip(t.shape[:3], (sb, sh, sn)):
        if n == 1 and (st <= 0 or st * 2 % _TMA_BYTES):
            out.append(_TMA_BYTES // 2)
        elif st <= 0 or st * 2 % _TMA_BYTES:
            raise ValueError(f"{name}: the tensor-core kernel loads with TMA, "
                             f"which needs strides of 16-byte multiples; got "
                             f"{tuple(t.stride())} elements of 2 bytes")
        else:
            out.append(st)
    return tuple(out)


def _tma_loadable(t: torch.Tensor) -> bool:
    """Whether TMA can load the bf16 (b, h, n, d) view as it lies."""
    try:
        _tma_strides(t, "")
    except ValueError:
        return False
    return True


def _pair_strides(t: torch.Tensor, name: str) -> tuple:
    """(b, h, n) strides of a bf16 (b, h, n, d) output that the tensor-core
    kernels store as bf16 pairs from registers: 4-byte aligned base and
    even strides, else ValueError."""
    st = t.stride()[:3]
    if t.data_ptr() % 4 or (st[0] | st[1] | st[2]) & 1:
        raise ValueError(f"{name}: the tensor-core kernel stores bf16 pairs, "
                         f"which needs 4-byte alignment; strides "
                         f"{tuple(t.stride())}")
    return st


# head dim -> the head dim the wgmma tiles span: whole 64-column boxes
_PADDED = {d: -(-d // _BOX_COLS) * _BOX_COLS for d in _HEAD_DIMS}


def launch_plan(q, k, v, out) -> LaunchPlan:
    """The forward kernel for (b, h, n, d) views that ``_check`` accepted:
    bf16 runs on the tensor cores, with the head dim padded to whole 64-column
    TMA boxes (d = 104 spans 128, its last 24 columns zero-filled; 16, 32 and
    64 span 64); f32 runs on the CUDA cores in full f32. Raises ValueError
    for a bf16 view that TMA cannot load or an output that bf16 pair stores
    cannot write."""
    d = q.shape[-1]
    if q.dtype == torch.float32:
        return LaunchPlan("cuda_core", d, d, 0, q.stride()[:3]
                          + k.stride()[:3] + v.stride()[:3]
                          + out.stride()[:3])
    return LaunchPlan("wgmma", d, _PADDED[d], _BOX_COLS,
                      _tma_strides(q, "q") + _tma_strides(k, "k")
                      + _tma_strides(v, "v") + _pair_strides(out, "out"))


def bwd_launch_plan(q, k, v, dout, grads: dict) -> LaunchPlan:
    """The backward kernel (K4 for ``grads`` {"dq": dq}, K5 for {"dk": dk,
    "dv": dv}) for (b, h, n, d) views that ``_check`` accepted: bf16 runs on
    the tensor cores, the head dim padded to whole 64-column TMA boxes as in
    ``launch_plan``; f32 on the CUDA cores in full f32. Raises ValueError for
    a bf16 q, k, v or dout that TMA cannot load, or a gradient that bf16
    pair stores cannot write."""
    d = q.shape[-1]
    if q.dtype == torch.float32:
        g = tuple(st for t in grads.values() for st in t.stride()[:3])
        return LaunchPlan("cuda_core", d, d, 0, q.stride()[:3]
                          + k.stride()[:3] + v.stride()[:3]
                          + dout.stride()[:3] + g + (0,) * (6 - len(g)))
    g = tuple(st for name, t in grads.items() for st in _pair_strides(t, name))
    return LaunchPlan("wgmma", d, _PADDED[d], _BOX_COLS,
                      _tma_strides(q, "q") + _tma_strides(k, "k")
                      + _tma_strides(v, "v") + _tma_strides(dout, "dout")
                      + g + (0,) * (6 - len(g)))


def _launch(q, k, v, kv_mask, out, lse=None, *, scale: float,
            softclamp: float | None) -> None:
    """Run the forward kernel on (b, h, n, d) views with contiguous last
    dims, writing into the (b, h, nq, d) view ``out`` and, if given, the
    contiguous f32 (b, h, nq) ``lse``."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    kv_mask = _check(q, k, v, kv_mask, {"out": out})
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match q")
    if lse is not None and (lse.shape != (b, h, nq) or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous f32 (b, h, nq) tensor")
    plan = launch_plan(q, k, v, out)
    lib = _library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None)
    m_sb = kv_mask.stride(0) if kv_mask is not None else 0
    clamp = float(softclamp) if softclamp is not None else 0.0
    with torch.cuda.device(q.device):
        if plan.route == "wgmma":
            err = lib.v2ap_flash_fwd_sm90(
                d, *ptrs, b, h, nq, nk, *plan.strides, m_sb, float(scale),
                clamp, _stream(q))
        else:
            err = lib.v2ap_flash_fwd(d, *ptrs, b, h, nq, nk, *plan.strides,
                                     m_sb, float(scale), clamp, _stream(q))
    _raise_on(err, lib, "flash kernel", q)


def _launch_bwd(which: str, q, k, v, kv_mask, lse, delta, dout, grads, *,
                scale: float, softclamp: float | None) -> None:
    """Run K4 (``which="dq"``, grads = (dq,)) or K5 (``which="dkv"``,
    grads = (dk, dv)) on (b, h, n, d) views; lse and delta are contiguous
    f32 (b, h, nq)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    names = ("dq",) if which == "dq" else ("dk", "dv")
    kv_mask = _check(q, k, v, kv_mask,
                     {"dout": dout, **dict(zip(names, grads))})
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, nq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous f32 (b, h, nq) "
                             f"tensor on {q.device}")
    likes = (q,) if which == "dq" else (k, v)
    for name, t, like in zip(("dout",) + names, (dout,) + tuple(grads),
                             (q,) + likes):
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match its input")
    plan = bwd_launch_plan(q, k, v, dout, dict(zip(names, grads)))
    m_sb = kv_mask.stride(0) if kv_mask is not None else 0
    arr = (ctypes.c_longlong * 19)(*plan.strides, m_sb)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None,
            lse.data_ptr(), delta.data_ptr(), grads[0].data_ptr(),
            grads[1].data_ptr() if len(grads) > 1 else None)
    args = (b, h, nq, nk, arr, float(scale),
            float(softclamp) if softclamp is not None else 0.0, _stream(q))
    lib = _library()
    with torch.cuda.device(q.device):
        if plan.route == "wgmma":
            err = lib.v2ap_flash_bwd_sm90(which == "dkv", d, *ptrs, *args)
        else:
            err = lib.v2ap_flash_bwd(which == "dkv", d, *ptrs, *args)
    _raise_on(err, lib, f"flash backward ({which}) kernel", q)


# --------------------------------------------------------------------------- #
# K3, K4, K5 wrappers and the autograd Function over them
# --------------------------------------------------------------------------- #

def _new_like_heads(t: torch.Tensor, heads: int | None) -> torch.Tensor:
    """A fresh buffer shaped like ``t``: packed (b, n, h*d) as is, 4D
    (b, h, n, d) as a view of a (b, n, h, d) buffer (heads merge for free)."""
    if heads is not None:
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)
    b, h, n, d = t.shape
    return torch.empty((b, n, h, d), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _into(dst: torch.Tensor | None, value: torch.Tensor) -> torch.Tensor:
    """The plain version's result, copied into ``dst`` if one was given."""
    return value if dst is None else dst.copy_(value)


def attention_fwd_lse(q, k, v, kv_mask=None, *, softclamp=None, scale=None,
                      out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on (b, h, n, d) views: (out, f32 (b, h, nq) lse). The output goes
    to ``out`` (a (b, h, nq, d) view) if given."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        ref, lse = attention_fwd_lse_reference(q, k, v, kv_mask,
                                               softclamp=softclamp,
                                               scale=scale)
        return _into(out, ref), lse
    b, h, nq, _ = q.shape
    out = _new_like_heads(q, None) if out is None else out
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, kv_mask, out, lse, scale=scale, softclamp=softclamp)
    count_launch("flash_attention_lse")
    return out, lse


def attention_bwd_dq(q, k, v, kv_mask, lse, delta, dout, *, softclamp=None,
                     scale=None, dq=None) -> torch.Tensor:
    """K4 on (b, h, n, d) views: dq, into ``dq`` if given."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return _into(dq, attention_bwd_reference(
            q, k, v, kv_mask, lse, delta, dout, softclamp=softclamp,
            scale=scale)[0])
    dq = _new_like_heads(q, None) if dq is None else dq
    _launch_bwd("dq", q, k, v, kv_mask, lse, delta, dout, (dq,),
                scale=scale, softclamp=softclamp)
    count_launch("flash_attention_bwd_dq")
    return dq


def attention_bwd_dkv(q, k, v, kv_mask, lse, delta, dout, *, softclamp=None,
                      scale=None, dk=None, dv=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on (b, h, n, d) views: (dk, dv), into ``dk`` / ``dv`` if given."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        _, dk_ref, dv_ref = attention_bwd_reference(
            q, k, v, kv_mask, lse, delta, dout, softclamp=softclamp,
            scale=scale)
        return _into(dk, dk_ref), _into(dv, dv_ref)
    dk = _new_like_heads(k, None) if dk is None else dk
    dv = _new_like_heads(v, None) if dv is None else dv
    _launch_bwd("dkv", q, k, v, kv_mask, lse, delta, dout, (dk, dv),
                scale=scale, softclamp=softclamp)
    count_launch("flash_attention_bwd_dkv")
    return dk, dv


def _views(heads: int | None):
    """(b, n, h*d) -> (b, h, n, d) head views for ``heads``; identity for
    tensors already (b, h, n, d) (``heads`` None)."""
    if heads is None:
        return lambda t: t
    return lambda t: _heads_view(t, heads, t.shape[-1] // heads)


class _FlashAttentionFn(torch.autograd.Function):
    """Counterpart of ``_packed_ad`` (``heads`` given, packed (b, n, h*d)
    tensors) and ``_flash_ad`` (``heads`` None, (b, h, n, d) tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, heads, softclamp, scale):
        views = _views(heads)
        kw = dict(softclamp=softclamp, scale=scale)
        if kv_mask is not None:
            kv_mask = kv_mask.to(device=q.device, dtype=torch.bool)
        out = _new_like_heads(q, heads)
        _, lse = attention_fwd_lse(views(q), views(k), views(v), kv_mask,
                                   out=views(out), **kw)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.heads, ctx.kw = heads, kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        heads, kw = ctx.heads, ctx.kw
        views = _views(heads)
        g = g.to(out.dtype)
        # the kernels take a contiguous last dim, the bf16 ones also what
        # TMA can load: copy a gradient autograd hands in otherwise (e.g.
        # expanded, with zero strides)
        if g.stride(-1) != 1 or (g.dtype == torch.bfloat16
                                 and not _tma_loadable(views(g))):
            g = g.contiguous()
        # D = rowsum(dO * O), outside the kernels as in JAX
        delta = (views(g).float() * views(out).float()).sum(-1).contiguous()
        args = (views(q), views(k), views(v), kv_mask, lse, delta, views(g))
        dq, dk, dv = (_new_like_heads(t, heads) for t in (q, k, v))
        attention_bwd_dq(*args, dq=views(dq), **kw)
        attention_bwd_dkv(*args, dk=views(dk), dv=views(dv), **kw)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    """Attention on (b, h, n, d) tensors (K2; K3-K5 under autograd).
    Returns (b, h, nq, d); on CUDA the result is a (b, h, nq, d) view of a
    (b, nq, h, d) buffer, so merging the heads back afterwards costs no
    copy."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, kv_mask, None, softclamp,
                                       scale)
    if not q.is_cuda:
        return attention_reference(q, k, v, kv_mask, softclamp=softclamp,
                                   scale=scale)
    out = _new_like_heads(q, None)
    _launch(q, k, v, kv_mask, out, scale=scale, softclamp=softclamp)
    count_launch("flash_attention")
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
    """Attention on head-packed (b, n, h*d) tensors (K1; K3-K5 under
    autograd), e.g. the three slices of a fused qkv projection, without
    materialising head transposes. Returns (b, nq, h*d)."""
    scale = scale if scale is not None else dim_head ** -0.5
    if q.shape[-1] != heads * dim_head:
        raise ValueError(f"packed width {q.shape[-1]} != {heads} x {dim_head}")
    if _needs_grad(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, kv_mask, heads, softclamp,
                                       scale)
    qh, kh, vh = (_heads_view(t, heads, dim_head) for t in (q, k, v))
    if not q.is_cuda:
        out = attention_reference(qh, kh, vh, kv_mask, softclamp=softclamp,
                                  scale=scale)
        return out.transpose(1, 2).flatten(2)
    out = _new_like_heads(q, heads)
    _launch(qh, kh, vh, kv_mask, _heads_view(out, heads, dim_head),
            scale=scale, softclamp=softclamp)
    count_launch("flash_attention_packed")
    return out
