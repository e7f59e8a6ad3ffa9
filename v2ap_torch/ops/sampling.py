"""ODE sampling utilities: sway timestep schedule, fixed-grid integration,
and the CFG parallel-component projection.

Counterpart of ``v2ap_tpu/ops/sampling.py``. The JAX package runs the
trajectory as one ``lax.scan``; here it is a Python loop over the same
float32 grid.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def sway_timesteps(steps: int, sway: bool = True) -> np.ndarray:
    """t in [0,1]; sway warp t <- t - (cos(pi/2 t) - 1 + t), in float64,
    returned as float32."""
    t = np.linspace(0.0, 1.0, steps, dtype=np.float64)
    if sway:
        t = t + -1.0 * (np.cos(np.pi / 2.0 * t) - 1.0 + t)
    return t.astype(np.float32)


def euler_integrate(
    fn: Callable[[float, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    ts: np.ndarray,
    method: str = "euler",
) -> torch.Tensor:
    """Fixed-grid integration over ``ts`` (float32, shape (steps,)),
    returning y(T). 'euler' makes one ``fn`` eval per step, 'midpoint' and
    'heun' two. Step arithmetic on t and dt is float32, as in the scan."""
    ts = np.asarray(ts, np.float32)
    if method not in ("euler", "midpoint", "heun"):
        raise ValueError(f"unknown ODE method '{method}'")
    half, two = np.float32(0.5), np.float32(2.0)
    y = y0
    for t, dt in zip(ts[:-1], ts[1:] - ts[:-1]):
        if method == "euler":
            y = y + float(dt) * fn(float(t), y)
        elif method == "midpoint":
            k1 = fn(float(t), y)
            k2 = fn(float(t + dt / two), y + float(dt / two) * k1)
            y = y + float(dt) * k2
        else:
            k1 = fn(float(t), y)
            k2 = fn(float(t + dt), y + float(dt) * k1)
            y = y + float(dt * half) * (k1 + k2)
    return y


def project_parallel(x: torch.Tensor, y: torch.Tensor):
    """Split x into components parallel/orthogonal to y over all-but-batch
    dims (arXiv 2410.02416 CFG fix)."""
    b = x.shape[0]
    xf = x.reshape(b, -1).float()
    yf = y.reshape(b, -1).float()
    unit = yf / torch.sqrt(torch.clamp(torch.sum(yf * yf, dim=-1, keepdim=True),
                                       min=1e-24))
    parallel = torch.sum(xf * unit, dim=-1, keepdim=True) * unit
    orthogonal = xf - parallel
    return (parallel.reshape(x.shape).to(x.dtype),
            orthogonal.reshape(x.shape).to(x.dtype))
