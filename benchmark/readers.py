"""What the metric readers share: medians of the pipeline's own stage
timings, kernel rooflines, the whole request's share of the chip's peak,
and the device's idle share, all over a ``harness.Run``.

The window's calls run without the profiler, which slows the host; so the
shares of the chip (``mfu_pct``, ``idle_pct``) divide by the window's
time, and the trace gives only the device's busy time of a call."""

from __future__ import annotations

from benchmark import counts
from benchmark.reference.pipeline import plan_length
from benchmark.stats import median


def stage_median(run, key: str):
    """Median over the window's calls of one stage of the pipeline's
    ``last_timings`` (seconds); None where no call timed that stage."""
    values = [r.timings[key] for r in run.window_records()
              if key in r.timings]
    return median(values) if values else None


def roofline_pct(run, fragments: tuple, least_seconds: float):
    """100 x the least time the traced calls' attention needs over the
    device time of the kernels named by ``fragments`` in the trace; None
    without a trace or without such kernels."""
    if run.trace is None:
        return None
    kernels = run.trace.kernels(*fragments)
    busy = sum(d for _, _, d in kernels) / 1e6
    if not busy or least_seconds <= 0:
        return None
    return 100.0 * run.traced_calls * least_seconds / busy


def packed_attention_least_s(run) -> float:
    """Least seconds of one call's flow-model attention (K1's work)."""
    cfg, t = run.cell.config, run.cell.traffic
    _, _, n = plan_length(cfg, t["clip_s"])
    batch = t["batch"] if t["kind"] == "batch" else 1
    per_eval = sum(counts.attention_bound(*shape[:5], mask_bytes=shape[5])
                   for shape in counts.packed_attention_calls(
                       cfg, batch, n, counts.context_len(t)))
    return (cfg["sampler"]["steps"] - 1) * per_eval


def vit_attention_least_s(run, tower: str) -> float:
    """Least seconds of one call's attention in a ViT tower (K2's work),
    0 where the configuration has no such tower."""
    cfg, t = run.cell.config, run.cell.traffic
    if tower not in cfg["towers"]:
        return 0.0
    batch = t["batch"] if t["kind"] == "batch" else 1
    frames = batch * counts.encoded_frames(t, cfg)
    return sum(counts.attention_bound(*shape[:5], mask_bytes=shape[5])
               for shape in counts.vit_attention_calls(cfg["towers"][tower],
                                                       frames))


def mfu_pct(run):
    """100 x the model operations of the calls completed in the window
    over the window's seconds at the bf16 peak; None without a device
    trace (a run off the card)."""
    done = [r for r in run.window_records() if r.waves is not None]
    if run.trace is None or not run.trace.device_ops or not done \
            or run.window_s <= 0:
        return None
    flops = len(done) * sum(run.flops().values())
    return 100.0 * flops / (run.window_s * counts.BF16_FLOP_PER_S)


def idle_pct(run):
    """100 x the share of the window's time in which no device operation
    ran: one - the traced calls' device busy seconds (the union of their
    intervals) a call x the window's calls / the window's seconds."""
    calls = len(run.window_records())
    if run.trace is None or not run.trace.device_ops or not calls \
            or not run.traced_calls or run.window_s <= 0:
        return None
    busy = run.trace.busy_s() / run.traced_calls * calls
    return 100.0 * (1.0 - busy / run.window_s)
