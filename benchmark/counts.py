"""The yardstick's arithmetic: the H100's peaks, the least time an
attention call needs, and the operations a served request needs.

Peaks are NVIDIA's for one H100 SXM (dense, 700 W): 989 TFLOP/s in bf16
on the tensor cores and 3.35 TB/s of HBM. A request's operations are the
model operations of the plain reference at the request's shapes, counted
by ``torch.utils.flop_counter`` on the meta device (products and
convolutions; 2 per multiply-add), so they follow the configuration and do
not depend on what implements them. Frame geometry (integer resampling)
and element-wise work are not counted.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.cfm import CFM
from benchmark.reference.encodec import EncodecDecoder
from benchmark.reference.pipeline import plan_length, tower_names
from benchmark.reference.t5 import T5Encoder
from benchmark.reference.towers import TOWERS
from benchmark.reference.video2roll import Video2RollNet

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
PROMPT_TOKENS = 64              # the hash tokenizer's width


def attention_bound(b, h, nq, nk, d, elem_bytes=2, mask_bytes=0) -> float:
    """Least seconds for one attention forward on the card: q, k, v read
    once and the output written once at the HBM rate, or 4 b h nq nk d
    operations at the bf16 rate, whichever is longer."""
    nbytes = elem_bytes * (2 * b * h * nq * d + 2 * b * h * nk * d) \
        + mask_bytes
    return max(nbytes / HBM_BYTES_PER_S,
               4.0 * b * h * nq * nk * d / BF16_FLOP_PER_S)


def packed_attention_calls(cfg: dict, batch: int, n: int, ctx_len: int):
    """Shapes (b, h, nq, nk, d, mask bytes) of the flow model's attention
    calls in one CFG evaluation (``batch`` clips, doubled) over ``n``
    latents: per layer the audio self- and cross-attention, and within
    ``text_depth`` the video-feature and roll streams' self-attention."""
    m = cfg["model"]
    b, t = 2 * batch, n + m["num_registers"]
    calls = []
    for i in range(m["depth"]):
        calls.append((b, m["heads"], t, t, m["dim_head"], b * t))
        calls.append((b, m["heads"], t, ctx_len, m["dim_head"], b * ctx_len))
        if i < m["text_depth"]:
            calls.append((b, m["text_heads"], t, t, m["text_dim_head"], b * t))
            calls.append((b, m["frames_heads"], t, t, m["frames_dim_head"],
                          b * t))
    return calls


def vit_attention_calls(tower: dict, frames: int):
    """Shapes of a CLIP ViT tower's attention calls over ``frames``
    frames (one per layer; no mask)."""
    n = (tower["image_size"] // tower["patch_size"]) ** 2 + 1
    h = tower["num_heads"]
    return [(frames, h, n, n, tower["hidden_size"] // h, 0)] \
        * tower["num_layers"]


def encoded_frames(traffic: dict, cfg: dict) -> int:
    frames = int(round(traffic["clip_s"] * traffic["fps"]))
    return -(-frames // cfg["conditioning"]["frame_stride"])


def context_len(traffic: dict) -> int:
    return PROMPT_TOKENS if traffic["prompt_words"][1] > 0 else 1


def _flops(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def tower_flops(cfg: dict, name: str, frames: int) -> float:
    tc = cfg["towers"][name]
    model = TOWERS[name][0](tc, device="meta")
    s = tc["image_size"]
    return _flops(lambda: model(_meta(frames, s, s, 3)))


def cfm_eval_flops(cfg: dict, batch: int, n: int, ctx_len: int) -> float:
    """One batch-doubled CFG evaluation of the flow model."""
    m = cfg["model"]
    model = CFM(m, cfg["conditioning"], device="meta")
    b = 2 * batch
    mask = torch.ones(b, n, dtype=torch.bool, device="meta")
    return _flops(lambda: model.pred_head(
        _meta(b, n, m["num_channels"]), _meta(b), mask,
        _meta(b, n, m["dim_text_raw"] or m["dim_text"]),
        _meta(b, n, m["notes"]), _meta(b, ctx_len, m["dim_context"]),
        torch.ones(b, ctx_len, dtype=torch.bool, device="meta")))


def t5_flops(cfg: dict, batch: int) -> float:
    model = T5Encoder(cfg["t5"], device="meta")
    ids = torch.zeros(batch, PROMPT_TOKENS, dtype=torch.long, device="meta")
    mask = torch.ones(batch, PROMPT_TOKENS, dtype=torch.bool, device="meta")
    return _flops(lambda: model(ids, mask))


def roll_flops(cfg: dict, n: int, traffic: dict) -> float:
    """Video2Roll over the roll's windows (one per roll row)."""
    m, c = cfg["model"], cfg["conditioning"]
    vm = 3.0 if m["notes"] == 51 else 2.5
    rows = int(math.floor(n / vm)) + 1
    model = Video2RollNet(m["notes"], device="meta")
    return _flops(lambda: model(_meta(rows, c["piano_window"],
                                      traffic["strip_h"],
                                      traffic["strip_w"])))


def decoder_flops(cfg: dict, batch: int, nv: int) -> float:
    model = EncodecDecoder(cfg["encodec"], device="meta")
    return _flops(lambda: model(_meta(batch, nv,
                                      cfg["encodec"]["hidden_size"])))


def request_flops(cfg: dict, traffic: dict) -> dict:
    """Model operations of one request (single) or call (batch), by part:
    each tower over the encoded frames, T5 over the prompt, Video2Roll
    over the roll's windows, the sampler's CFG evaluations and the
    decoder."""
    batch = traffic["batch"] if traffic["kind"] == "batch" else 1
    _, nv, n = plan_length(cfg, traffic["clip_s"])
    frames = encoded_frames(traffic, cfg)
    ctx = context_len(traffic)
    out = {f"tower.{name}": batch * tower_flops(cfg, name, frames)
           for name in tower_names(cfg)}
    if ctx > 1:
        out["t5"] = t5_flops(cfg, batch)
    if traffic["piano"]:
        out["video2roll"] = batch * roll_flops(cfg, n, traffic)
    out["cfm"] = (cfg["sampler"]["steps"] - 1) * cfm_eval_flops(
        cfg, batch, n, ctx)
    out["decoder"] = decoder_flops(cfg, batch, nv)
    return out

