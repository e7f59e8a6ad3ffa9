"""Stage timing, profiling and metrics logging.

Counterpart of ``v2ap_tpu/utils/observability.py``:

  * ``StageTimer`` — wall time per named stage, with audio-seconds per
    wall-second;
  * ``profile_trace`` — ``torch.profiler`` over a block, its trace written
    as a Chrome trace file (``trace.json``) under the directory;
  * ``MetricsLogger`` — JSONL metrics (always), TensorBoard scalars when
    ``torch.utils.tensorboard`` imports, latent "spectrogram" figures when
    matplotlib imports.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, audio_seconds: Optional[float] = None) -> dict:
        out = {name: {"seconds": round(t, 4), "calls": self.counts[name]}
               for name, t in self.totals.items()}
        total = sum(self.totals.values())
        out["total_seconds"] = round(total, 4)
        if audio_seconds is not None and total > 0:
            out["realtime_factor"] = round(audio_seconds / total, 3)
        return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` (CPU, and CUDA where there is a card) over the
    block; the trace goes to ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def log_spectrogram(self, step: int, name: str, latents) -> None:
        """Write ``latents`` (n, channels) as a figure ``<name>_<step>.png``
        (and to TensorBoard), when matplotlib imports."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import numpy as np
            if hasattr(latents, "detach"):
                latents = latents.detach().float().cpu().numpy()
            fig, ax = plt.subplots(figsize=(10, 3))
            ax.imshow(np.asarray(latents).T, aspect="auto", origin="lower")
            ax.set_title(f"{name} step {step}")
            path = os.path.join(self.log_dir, f"{name}_{step}.png")
            fig.savefig(path, dpi=80, bbox_inches="tight")
            if self._tb is not None:
                self._tb.add_figure(name, fig, step)
            plt.close(fig)
        except Exception:
            pass

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
