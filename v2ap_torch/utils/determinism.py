"""Determinism and numerical-sanity checks.

Counterpart of ``v2ap_tpu/utils/determinism.py``:

  * ``assert_deterministic`` runs a function twice (or ``runs`` times) and
    demands bit-identical outputs over nested tensors (it catches
    non-deterministic kernels and collectives);
  * ``debug_nans`` traps the first operation whose floating output holds a
    NaN, forward or backward, and names it (JAX's ``jax_debug_nans``;
    ``torch.autograd.set_detect_anomaly`` covers only the backward pass);
  * ``tree_finite_report`` names every non-finite leaf of nested
    containers or of a module's ``state_dict``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _leaves(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) of nested dicts / lists / tuples, in order."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, x))

    walk(tree, "")
    return out


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def assert_deterministic(fn: Callable, *args, runs: int = 2,
                         **kwargs) -> None:
    """Run ``fn(*args, **kwargs)`` ``runs`` times; raise AssertionError
    naming the max |delta| if any output leaf differs from the first
    run's (NaNs compare equal)."""
    ref = [_host(x) for _, x in _leaves(fn(*args, **kwargs))]
    for i in range(1, runs):
        out = [_host(x) for _, x in _leaves(fn(*args, **kwargs))]
        if len(out) != len(ref):
            raise AssertionError(f"non-deterministic output on run {i}: "
                                 f"{len(out)} leaves, then {len(ref)}")
        for a, b in zip(ref, out):
            if not np.array_equal(a, b, equal_nan=True):
                diff = np.max(np.abs(np.asarray(a, np.float64)
                                     - np.asarray(b, np.float64)))
                raise AssertionError(
                    f"non-deterministic output on run {i}: max |delta|={diff}")


class _NaNTrap(TorchDispatchMode):
    """Raise at the first operation with a NaN in a floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat, _ = tree_flatten(out)
        for t in flat:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.device.type != "meta"
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Inside the block, the first operation (forward or backward) whose
    floating output holds a NaN raises ``FloatingPointError`` naming it.
    Each operation's outputs are checked on the host's side of a
    synchronisation, so the block runs slower; ``enable=False`` is a
    no-op."""
    if not enable:
        yield
        return
    with _NaNTrap():
        yield


def tree_finite_report(tree, prefix: str = "") -> List[str]:
    """Paths of non-finite floating leaves of nested dicts / lists /
    tuples of tensors or arrays; a module is read through its
    ``state_dict`` (its parameter and buffer names)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf.detach()).all()):
                bad.append(prefix + path)
        elif hasattr(leaf, "dtype") and np.issubdtype(
                np.asarray(leaf).dtype, np.floating):
            if not bool(np.isfinite(np.asarray(leaf)).all()):
                bad.append(prefix + path)
    return bad
