"""Faults planted in the v2ap family's timed path, to show that
``correct`` comes out false when the path is broken. Each takes
``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
``planted``'s own) and breaks one thing underneath the harness:

  answer       every waveform a call returns scaled by 1.05
  half-batch   the second half of a batch call's clips replaced by the
               mean of the first half
  step         the sampler's last step returns its state unchanged
  step-mid     the sampler's middle step returns its state unchanged
  roll         the piano roll shifted by one frame where it is produced
  int8-per-tensor  one activation scale for the whole tensor instead of one
               a token in every int8 product (the towers' under
               ``quantize_towers``): the shortcut a fused quantize could take
  bf16-towers  the int8 products computed as plain bf16 ones, as if the
               towers skipped int8

A fault that patches the sampler must be planted before the pipeline is
built: the captured sampler records the integration it runs.
"""

from __future__ import annotations

import contextlib

import numpy as np


def altered_answer(patch) -> None:
    from benchmark.system import System

    serve = System.serve

    def altered(self, request, kind, x0=None):
        waves, roll, timings = serve(self, request, kind, x0)
        return waves * 1.05, roll, timings

    patch(System, "serve", altered)


def half_batch(patch) -> None:
    from benchmark.system import System

    serve = System.serve

    def half(self, request, kind, x0=None):
        waves, roll, timings = serve(self, request, kind, x0)
        b = len(waves) // 2
        waves = waves.copy()
        waves[b:] = waves[:b].mean(axis=0)
        return waves, roll, timings

    patch(System, "serve", half)


def _step_unchanged(patch, middle: bool) -> None:
    import v2ap_torch.models.cfm as cfm
    import v2ap_torch.ops.sampling as sampling

    def integrate(fn, y0, ts, method="euler"):
        ts = np.asarray(ts, np.float32)
        steps = len(ts) - 1
        k = steps // 2 if middle else steps - 1   # from ts[k] to ts[k + 1]
        y = sampling.euler_integrate(fn, y0, ts[:k + 1], method)
        return sampling.euler_integrate(fn, y, ts[k + 1:], method)

    patch(cfm, "euler_integrate", integrate)


def step_unchanged(patch) -> None:
    _step_unchanged(patch, middle=False)


def middle_step_unchanged(patch) -> None:
    _step_unchanged(patch, middle=True)


def roll_altered(patch) -> None:
    import v2ap_torch.models.cfm as cfm

    encode = cfm.CFM.encode_frames

    def altered(self, frames, length):
        return encode(self, frames, length).roll(1, dims=1)

    patch(cfm.CFM, "encode_frames", altered)


def int8_per_tensor(patch) -> None:
    import v2ap_torch.ops.layers as layers
    from v2ap_torch.utils.quantize import int8_matmul, quantize_rows

    def per_tensor(x, weight, bias=None):
        lead = x.shape[:-1]
        qx, sx = quantize_rows(x.reshape(1, -1))
        qw, sw = quantize_rows(weight)
        acc = int8_matmul(qx.reshape(-1, x.shape[-1]), qw)
        y = acc.to(x.dtype) * sx * sw.reshape(1, -1)
        if bias is not None:
            y = y + bias
        return y.reshape(*lead, weight.shape[0])

    patch(layers, "int8_linear", per_tensor)


def int8_skipped(patch) -> None:
    import torch.nn.functional as F

    import v2ap_torch.ops.layers as layers

    def plain(x, weight, bias=None):
        return F.linear(x, weight, bias)

    patch(layers, "int8_linear", plain)


FAULTS = {"answer": altered_answer, "half-batch": half_batch,
          "step": step_unchanged, "step-mid": middle_step_unchanged,
          "roll": roll_altered, "int8-per-tensor": int8_per_tensor,
          "bf16-towers": int8_skipped}


@contextlib.contextmanager
def planted(name: str):
    """The ``with`` body runs with fault ``name`` planted; undone after."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
