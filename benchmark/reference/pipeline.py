"""The plain reference of a served request, end to end, in float32 with
TF32 off: the towers' geometry and models over every ``frame_stride``-th
frame, the blend to the latent rate, T5 over the prompt, Video2Roll over
the blended keyboard strips, the seeded x0, the CFG sway sampler and
EnCodec's decoder. Each model is built only while it runs, from the
benchmark's weights (any dtype, widened to float32), so a mixed-tower
request holds one tower at a time.

The towers' ``Linear`` layers compute AQT's int8 product where the
configuration's ``quantize_towers`` is true (``reference.nn.int8_linear``);
their attention, norms and patch convolution stay float32. A configuration
with ``quantize_cfm`` true is refused: the reference has no int8 flow
model, and a float32 one would judge it without saying so.

``cfg`` is a configuration file's dict (``benchmark/configs``); ``weights``
maps "cfm", "decoder", "t5" and "towers" -> {name} to state dicts.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference.cfm import CFM
from benchmark.reference.encodec import EncodecDecoder
from benchmark.reference.nn import int8_linears
from benchmark.reference.t5 import T5Encoder, hash_tokenize
from benchmark.reference.towers import TOWERS, normalize, resize_center_crop

MAX_DURATION_S = 30.0           # the serving entry's clip ceiling
TOWER_CHUNK = 64                # frames through a tower at a time


@contextlib.contextmanager
def float32_exact():
    """float32 products without TF32, restored afterwards."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def build(module_cls, state: dict, *args, device):
    """``module_cls(*args)`` on the meta device, then ``state`` assigned to
    it as float32 tensors on ``device``."""
    model = module_cls(*args, device="meta")
    model.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                           for k, v in state.items()}, strict=True,
                          assign=True)
    return model.eval()


def tower_names(cfg: dict) -> list:
    mode = cfg["conditioning"]["video_encoder"]
    return list(TOWERS) if mode == "mixed" else [mode]


def plan_length(cfg: dict, dur_s: float):
    """(duration_s, valid latents, latents in their 96-bucket) under the
    positional ceiling."""
    m, c = cfg["model"], cfg["conditioning"]
    sr, hop = c["sampling_rate"], c["frame_size"]
    max_n = ((m["max_seq_len"] - m["num_registers"]) // 96) * 96
    nv = min(int(round(dur_s * sr / hop)), max_n)
    n = min(max(96, -(-nv // 96) * 96), max_n)
    return min(dur_s, nv * hop / sr), nv, n


def blend_plan(num: int, duration: float, length: int, stride: int,
               sr: int, hop: int):
    """Rows at the latent rate over ``num`` encoded frames spread evenly over
    ``duration``: nearest frame at stride 1, else (i0, i1, w) to blend."""
    samples = np.arange(0, int(duration * sr), hop)[:length]
    pos = (samples + hop // 2) / sr / (duration / max(num - 1, 1))
    if stride == 1:
        return np.clip(np.round(pos).astype(np.int64), 0, num - 1), None, None
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, num - 1)
    i1 = np.minimum(i0 + 1, num - 1)
    return i0, i1, np.clip(pos - i0, 0.0, 1.0).astype(np.float32)


def piano_plan(num: int, duration: float, length: int, stride: int,
               video_multi: float, sr: int, hop: int):
    """Full-rate strip index of each roll row (video_multi latents a row),
    then, at a strip stride above 1, its blend between strided strips."""
    step = int(video_multi * hop)
    rows = int(np.floor(length / video_multi)) + 1
    samples = np.arange(0, int(duration * sr) + step, step)[:rows]
    idx = np.clip(np.round(samples / sr / (duration / max(num, 1))
                           ).astype(np.int64), 0, num - 1)
    if stride == 1:
        return idx, None, None
    f = idx.astype(np.float64) / stride
    n_strided = (num + stride - 1) // stride
    i0 = np.clip(np.floor(f).astype(np.int64), 0, n_strided - 1)
    i1 = np.minimum(i0 + 1, n_strided - 1)
    w = (f - i0).astype(np.float32)
    w[i1 == i0] = 0.0
    return i0, i1, w


@torch.no_grad()
def tower_features(cfg, weights, clips, device, hook=None):
    """Per clip, tower name -> (encoded frames, width) float32 features of
    every ``frame_stride``-th frame: each clip is (uint8 (t, H, W, 3)
    full-rate frames, duration). Towers run one after another over every
    clip; ``hook(name, model)`` is called with each tower built."""
    stride = cfg["conditioning"]["frame_stride"]
    frames = [torch.from_numpy(np.ascontiguousarray(f[::stride])).to(device)
              for f, _ in clips]
    per_tower = []
    with float32_exact():
        for name in tower_names(cfg):
            cls, _, mean, std = TOWERS[name]
            tc = cfg["towers"][name]
            model = build(cls, weights["towers"][name], tc, device=device)
            if cfg["quantize_towers"]:
                int8_linears(model)
            if hook is not None:
                hook(name, model)
            outs = []
            for f in frames:
                parts = [model(normalize(resize_center_crop(
                    f[i: i + TOWER_CHUNK], tc["image_size"]), mean, std))
                    for i in range(0, len(f), TOWER_CHUNK)]
                outs.append(torch.cat(parts))
            per_tower.append(outs)
            del model
    return [dict(zip(tower_names(cfg), t)) for t in zip(*per_tower)]


def join_towers(cfg, features: dict) -> torch.Tensor:
    """One clip's tower name -> (frames, width) features, cut to the fewest
    frames and concatenated along the width in ``tower_names`` order, as
    float32."""
    per_tower = [features[name] for name in tower_names(cfg)]
    t = min(len(f) for f in per_tower)
    return torch.cat([f[:t].float() for f in per_tower], -1)


@torch.no_grad()
def video_features(cfg, weights, clips, length: int, device,
                   features=None):
    """Per-clip (length, sum of tower widths) float32 features at the
    latent rate: ``tower_features`` of the clips joined, or the per-clip
    (frames, widths) ``features`` given (the program's own, where the check
    follows it from its towers' output), blended to the latent rate."""
    cond = cfg["conditioning"]
    stride = cond["frame_stride"]
    if features is None:
        features = [join_towers(cfg, f)
                    for f in tower_features(cfg, weights, clips, device)]
    feats = []
    for f, (_, duration) in zip(features, clips):
        i0, i1, w = blend_plan(len(f), duration, length, stride,
                               cond["sampling_rate"], cond["frame_size"])
        if w is None:
            rows = f[torch.from_numpy(i0).to(device)]
        else:
            wc = torch.from_numpy(w).to(device)[:, None]
            rows = (f[torch.from_numpy(i0).to(device)] * (1.0 - wc)
                    + f[torch.from_numpy(i1).to(device)] * wc)
        feats.append(rows)
    return feats


@torch.no_grad()
def prompt_context(cfg, weights, prompts, device):
    ids, mask = hash_tokenize(prompts, cfg["t5"]["vocab_size"])
    t5 = build(T5Encoder, weights["t5"], cfg["t5"], device=device)
    mask = torch.from_numpy(mask).to(device).bool()
    return t5(torch.from_numpy(ids).to(device), mask), mask


@torch.no_grad()
def piano_roll(cfm, cfg, strips, duration, n, device):
    """Roll probabilities (1, n, notes) from full-rate uint8 strips."""
    cond, m = cfg["conditioning"], cfg["model"]
    ss = cond["strip_stride"]
    vm = 3.0 if m["notes"] == 51 else 2.5
    i0, i1, w = piano_plan(len(strips), duration, n, ss, vm,
                           cond["sampling_rate"], cond["frame_size"])
    s = torch.from_numpy(np.ascontiguousarray(strips[::ss])).to(device)
    s = s.float()
    if w is None:
        frames = s[torch.from_numpy(i0).to(device)] / 255.0
    else:
        wb = torch.from_numpy(w).to(device)[:, None, None]
        frames = (s[torch.from_numpy(i0).to(device)] * (1.0 - wb)
                  + s[torch.from_numpy(i1).to(device)] * wb) / 255.0
    return cfm.encode_frames(frames[None], n)


def normal(seed: int, shape, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


@torch.no_grad()
def sample_decode(cfm, cfg, weights, x0, text, roll, ctx, ctx_mask, nv,
                  device):
    n = x0.shape[1]
    b = x0.shape[0]
    mask = (torch.arange(n, device=device)[None] < nv).repeat(b, 1)
    s = cfg["sampler"]
    latents = cfm.sample(x0, text, roll, ctx, ctx_mask, mask, s["steps"],
                         s["cfg_strength"])
    decoder = build(EncodecDecoder, weights["decoder"], cfg["encodec"],
                    device=device)
    return decoder(latents[:, :nv])


def _precision(cfg) -> None:
    if cfg["quantize_cfm"]:
        raise ValueError("the reference has no int8 flow model: "
                         "quantize_cfm must be false")


def _empty_context(cfg, b, device):
    return (torch.zeros(b, 1, cfg["model"]["dim_context"], device=device),
            torch.ones(b, 1, dtype=torch.bool, device=device))


@torch.no_grad()
def single(cfg, weights, request, device, features=None):
    """One ``generate`` call: ``request`` has frames, duration, prompt,
    strips (None for V2A) and seed; ``features``, the program's per-frame
    tower features of the clip to start from instead of the reference's.
    Returns (waveform, roll or None) as float32 numpy."""
    _precision(cfg)
    with float32_exact():
        cond, m = cfg["conditioning"], cfg["model"]
        sr = cond["sampling_rate"]
        clip_dur = min(request["duration"], MAX_DURATION_S)
        duration_s, nv, n = plan_length(cfg, clip_dur)
        probe = int(MAX_DURATION_S * sr / cond["frame_size"])
        feats = video_features(cfg, weights,
                               [(request["frames"], request["duration"])],
                               probe, device,
                               None if features is None else [features])[0]
        tdim = m["dim_text_raw"] or m["dim_text"]
        text = torch.zeros(1, n, tdim, device=device)
        k = min(n, len(feats))
        text[0, :k] = feats[:k]
        if request["prompt"].strip():
            ctx, ctx_mask = prompt_context(cfg, weights, [request["prompt"]],
                                           device)
        else:
            ctx, ctx_mask = _empty_context(cfg, 1, device)
        cfm = build(CFM, weights["cfm"], m, cond, device=device)
        if request["strips"] is not None:
            roll = piano_roll(cfm, cfg, request["strips"],
                              request["duration"], n, device)
        else:
            roll = torch.zeros(1, n, m["notes"], device=device)
        x0 = normal(request["seed"], (1, n, m["num_channels"]), device)
        wav = sample_decode(cfm, cfg, weights, x0, text, roll, ctx, ctx_mask,
                            nv, device)
        out = wav[0, : int(duration_s * sr)].cpu().numpy()
        return out, (roll[0].cpu().numpy()
                     if request["strips"] is not None else None)


@torch.no_grad()
def batch(cfg, weights, call, device, features=None):
    """One ``generate_batch`` call of clips with empty prompts: ``call`` has
    frames (one array per clip), duration and x0_seed, from which x0
    (b, n, C) is drawn; ``features``, the program's per-frame tower
    features of each clip to start from instead of the reference's.
    Returns the (b, samples) float32 numpy waveforms."""
    _precision(cfg)
    with float32_exact():
        cond, m = cfg["conditioning"], cfg["model"]
        _, nv, n = plan_length(cfg, call["duration"])
        b = len(call["frames"])
        feats = video_features(cfg, weights,
                               [(f, call["duration"]) for f in call["frames"]],
                               nv, device, features)
        text = torch.zeros(b, n, m["dim_text_raw"] or m["dim_text"],
                           device=device)
        for i, f in enumerate(feats):
            text[i, : len(f)] = f[:n]
        ctx, ctx_mask = _empty_context(cfg, b, device)
        cfm = build(CFM, weights["cfm"], m, cond, device=device)
        roll = torch.zeros(b, n, m["notes"], device=device)
        x0 = normal(call["x0_seed"], (b, n, m["num_channels"]), device)
        wav = sample_decode(cfm, cfg, weights, x0, text, roll, ctx, ctx_mask,
                            nv, device)
        return wav[:, : int(call["duration"] * cond["sampling_rate"])
                   ].cpu().numpy()
