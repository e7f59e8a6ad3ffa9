"""Checkpoints: a model's state (``save_model`` / ``load_model``) and rolling
exact training state (``CheckpointManager``).

Counterpart of ``v2ap_tpu/utils/checkpoint.py``, as ``torch.save`` files of
state dicts, each written under a temporary name and moved into place with
``os.replace`` (a crash leaves the last complete file), and read with
``torch.load(weights_only=True)``. A model directory holds ``model.pt``: the
module's parameters and buffers, its dropout generator's state (the CFM's;
nnx saves its ``Rngs`` with the model) and the step. A training
checkpoint ``<directory>/<step>.pt`` holds what ``Trainer.state_dict``
gives: parameters, buffers, the dropout generator, the AdamW moments and
count, the EMA shadow and the step. The JAX package's orbax directories
are not read: the machines the port runs on have no orbax, so weights
cross between the packages through ``v2ap_torch.utils.convert``.

Under a process group every rank calls these functions: the state of a
tensor-parallel model (``parallel.shard_model``) is gathered to its
unsharded tensors, rank 0 writes the file and the others wait for it, so
a checkpoint written under a mesh is the one written without, and each
rank loads (and shards) the whole file.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from v2ap_torch.parallel.state import (full_state_dict, is_sharded,
                                       load_full_state_dict)

MODEL_FILE = "model.pt"
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    """Write ``obj`` (rank 0 only under a process group, the others wait
    until it is in place)."""
    distributed = dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)
    if distributed:
        dist.barrier()


def _generator(model: nn.Module) -> Optional[torch.Generator]:
    return getattr(model, "dropout_generator", None)


def save_model(path: str, model: nn.Module, *, step: int = 0,
               extra: Optional[dict] = None) -> None:
    """Save a module's parameters and buffers (and its dropout generator's
    state, where it has one) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    gen = _generator(model)
    state = full_state_dict(model) if is_sharded(model) else \
        model.state_dict()
    payload = {"state": state,
               "rng": gen.get_state() if gen is not None else None,
               "step": step}
    if extra:
        payload["extra"] = extra
    _atomic_save(payload, os.path.join(path, MODEL_FILE))


def load_model(path: str, model: nn.Module) -> int:
    """Restore what ``save_model`` wrote into ``model`` in place: each tensor
    copied into the model's own, in the model's dtype (a float32 state into
    layers stored in bf16 rounds as ``cast_params`` does). Returns the
    saved step."""
    payload = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                         weights_only=True, mmap=True)
    if is_sharded(model):
        load_full_state_dict(model, payload["state"])
    else:
        model.load_state_dict(payload["state"])
    gen = _generator(model)
    if gen is not None and payload["rng"] is not None:
        gen.set_state(payload["rng"])
    return int(payload["step"])


class CheckpointManager:
    """Rolling training checkpoints ``<directory>/<step>.pt`` with
    keep-last-``max_to_keep`` semantics."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for m in
                      map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer) -> None:
        """Write ``trainer.state_dict()`` as step ``step``, then delete all
        but the newest ``max_to_keep`` checkpoints."""
        _atomic_save(trainer.state_dict(), self.path(step))
        if not dist.is_initialized() or dist.get_rank() == 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        if dist.is_initialized():
            dist.barrier()

    def restore(self, trainer, step: Optional[int] = None) -> int:
        """Load step ``step`` (the latest when None) into ``trainer``;
        returns the step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        # on the host, memory-mapped: the tensors copy into the trainer's
        # own, and a generator's state must stay a CPU tensor
        state = torch.load(self.path(step), map_location="cpu",
                           weights_only=True, mmap=True)
        trainer.load_state_dict(state)
        return step
