"""The yardstick's arithmetic against hand counts: attention bounds, the
attention calls of a served request, and the model operations counted on
the meta device."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import counts
from benchmark.tests.tiny import tiny_config, tiny_traffic

REPO = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def _traffic(name):
    return json.loads((REPO / "benchmark" / "traffic" / f"{name}.json")
                      .read_text())


def test_attention_bound_by_hand():
    # (2, 16, 800, 800, 64): 4*2*16*800*800*64 = 5.24288e9 operations
    # over 989e12, against 2*(2*2*16*800*64*2) bytes + 1600 mask bytes
    ops_s = 4 * 2 * 16 * 800 * 800 * 64 / 989e12
    bytes_s = (2 * (2 * 2 * 16 * 800 * 64 * 2) + 1600) / 3.35e12
    assert counts.attention_bound(2, 16, 800, 800, 64, mask_bytes=1600) \
        == pytest.approx(max(ops_s, bytes_s))
    assert ops_s > bytes_s
    # ViT-bigG at 257 tokens, d 104: bound by bytes
    b = counts.attention_bound(64, 16, 257, 257, 104)
    assert b == pytest.approx(2 * 4 * 64 * 16 * 257 * 104 / 3.35e12)


def test_attention_calls_of_the_shipped_configs():
    cfg = _config("crossatt3")
    calls = counts.packed_attention_calls(cfg, 1, 768, 1)
    assert len(calls) == 48                 # 12 layers x 4; 1152 a request
    assert calls[0] == (2, 16, 800, 800, 64, 1600)
    assert calls[1] == (2, 16, 800, 1, 64, 2)
    assert calls[3] == (2, 8, 800, 800, 64, 1600)
    assert len(counts.packed_attention_calls(cfg, 8, 768, 1)) == 48
    vit = counts.vit_attention_calls(cfg["towers"]["clip_vit"], 84)
    assert len(vit) == 48 and vit[0] == (84, 16, 257, 257, 104, 0)
    assert counts.encoded_frames(_traffic("v2a-single"), cfg) == 84
    assert counts.context_len(_traffic("v2p-single")) == 64


def test_vit_operations_by_hand():
    cfg = tiny_config()
    tc = cfg["towers"]["clip_vit"]
    d, ff, layers, p = (tc["hidden_size"], tc["intermediate_size"],
                        tc["num_layers"], tc["patch_size"])
    n = (tc["image_size"] // p) ** 2
    frames = 5
    t = n + 1
    per_frame = (2 * n * d * 3 * p * p                 # patch embedding
                 + layers * (2 * t * 4 * d * d        # q, k, v, o
                             + 4 * t * t * d          # logits and mix
                             + 2 * 2 * t * d * ff)    # the MLP
                 + 2 * d * tc["projection_dim"])      # the projection
    assert counts.tower_flops(cfg, "clip_vit", frames) == frames * per_frame


def test_t5_operations_by_hand():
    cfg = tiny_config()
    c = cfg["t5"]
    d, inner, ff, n = (c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"],
                       counts.PROMPT_TOKENS)
    per_layer = 2 * n * (3 * d * inner + inner * d + 3 * d * ff) \
        + 4 * n * n * inner
    assert counts.t5_flops(cfg, 2) == 2 * c["num_layers"] * per_layer


def test_decoder_operations_by_hand():
    c = tiny_config()["encodec"]
    nv = 30
    hidden = c["num_filters"] * 2 ** len(c["upsampling_ratios"])
    lstm = c["num_lstm_layers"] * nv * 2 * 2 * hidden * 4 * hidden
    total = 2 * nv * hidden * c["hidden_size"] * c["kernel_size"] + lstm
    t, ch = nv, hidden
    for r in c["upsampling_ratios"]:
        total += 2 * t * ch * (ch // 2) * 2 * r       # transposed conv
        t, ch = t * r, ch // 2
        h = ch // c["compress"]
        total += 2 * t * (ch * h * c["residual_kernel_size"] + h * ch
                          + ch * ch)                  # residual block
    total += 2 * t * ch * c["audio_channels"] * c["last_kernel_size"]
    assert counts.decoder_flops({"encodec": c}, 1, nv) == total


def test_request_operations_add_their_parts():
    cfg, t = tiny_config(), tiny_traffic(piano=True)
    parts = counts.request_flops(cfg, t)
    assert set(parts) == {"tower.clip_vit", "t5", "video2roll", "cfm",
                          "decoder"}
    assert parts["cfm"] == (cfg["sampler"]["steps"] - 1) * \
        counts.cfm_eval_flops(cfg, 1, 192, counts.PROMPT_TOKENS)
    batch = dict(tiny_traffic("batch"))
    two = counts.request_flops(cfg, batch)
    one = counts.request_flops(cfg, dict(batch, batch=1))
    assert two["tower.clip_vit"] == 2 * one["tower.clip_vit"]
