"""Device selection and seeded construction for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises: the port
    never carries on quietly on the CPU; pass ``device="cpu"`` for that."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path on the CPU")
    return device


@contextlib.contextmanager
def seeded_init(seed: int, device: torch.device):
    """Build modules with parameter init drawn from ``seed`` on ``device``,
    leaving the caller's global RNG state untouched."""
    devices = ([device.index if device.index is not None
                else torch.cuda.current_device()]
               if device.type == "cuda" else [])
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield
