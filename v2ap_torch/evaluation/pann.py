"""PANN Cnn14 audio embedder and AudioSet tagger, the default FAD / IS / KL
model, in NCHW.

Counterpart of ``v2ap_tpu/evaluation/pann.py`` (Kong et al., "PANNs",
arXiv 1912.10211):

  waveform -> power spectrogram (Hann, centre / reflect) -> Slaney-scale,
  Slaney-normalised log-mel, 10 log10(clip(., amin)) -> bn0 over the mel
  bins -> 6 conv blocks (2x [3x3 conv, BN, ReLU], 2x2 VALID average pool,
  the sixth block too; 64..2048 channels) -> mean over mels -> max + mean
  over time -> fc1 + ReLU = the embedding; ``fc_audioset`` past it gives
  the 527 clipwise AudioSet logits.

The JAX package leaves the convolutions to XLA, outside Pallas, so here
they are ``F.conv2d``. Everything computes in float32 (``PannConfig.dtype``).
Weights: ``load_pann_from_state_dict`` reads the published ``Cnn14*.pth``
state dict, which is already in PyTorch's layout. Without weights the
model initialises from seed 0: fine for regression tests, not comparable
across codebases (``$V2AP_PANN_WEIGHTS`` for absolute FAD).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import BatchNorm2d, Conv2d, Linear
from v2ap_torch.ops.melspec import apply_filterbank, frame_power, mel_filterbank
from v2ap_torch.utils.device import resolve_device, seeded_init


@dataclasses.dataclass(frozen=True)
class PannConfig:
    sample_rate: int = 16_000
    n_fft: int = 512
    win_length: int = 512
    hop: int = 160
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 8_000.0
    embed_dim: int = 2048
    num_classes: int = 527            # AudioSet tagging head (fc_audioset)
    amin: float = 1e-10
    dtype: str = "float32"


def pann_16k() -> PannConfig:
    """Cnn14_16k, the AudioLDM-Eval FAD checkpoint."""
    return PannConfig()


def pann_32k() -> PannConfig:
    """The original Cnn14 (32 kHz, window 1024, hop 320, fmax 14 kHz)."""
    return PannConfig(sample_rate=32_000, n_fft=1024, win_length=1024,
                      hop=320, fmax=14_000.0)


def pann_tiny_test() -> PannConfig:
    return PannConfig(embed_dim=32, num_classes=10)


def pann_logmel(waveform: torch.Tensor, cfg: PannConfig) -> torch.Tensor:
    """(b, t) -> (b, frames, n_mels): torchlibrosa's log-mel (power
    spectrogram, Slaney mel, power_to_db with ref 1 and no top_db)."""
    power = frame_power(waveform, cfg.n_fft, cfg.hop, cfg.win_length,
                        power=2.0)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                        cfg.fmax, slaney_norm=True, slaney_scale=True)
    return 10.0 * torch.log10(torch.clamp(apply_filterbank(power, fb),
                                          min=cfg.amin))


class PannConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, *, dtype, device=None):
        super().__init__()
        kw = dict(padding=1, bias=False, dtype=dtype, device=device)
        self.conv1 = Conv2d(cin, cout, 3, **kw)
        self.bn1 = BatchNorm2d(cout, device=device)
        self.conv2 = Conv2d(cout, cout, 3, **kw)
        self.bn2 = BatchNorm2d(cout, device=device)

    def forward(self, x):                          # (b, c, t, m) NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, 2)                  # 2x2 VALID, / 4


class Cnn14(nn.Module):
    """waveform (b, t) -> embedding (b, embed_dim) float32."""

    def __init__(self, cfg: PannConfig | None = None, *, device=None):
        super().__init__()
        self.cfg = cfg = cfg or pann_16k()
        dtype = getattr(torch, cfg.dtype)
        widths = [64, 128, 256, 512, 1024, cfg.embed_dim]
        self.bn0 = BatchNorm2d(cfg.n_mels, device=device)
        blocks, cin = [], 1
        for cout in widths:
            blocks.append(PannConvBlock(cin, cout, dtype=dtype, device=device))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.fc1 = Linear(cfg.embed_dim, cfg.embed_dim, dtype=dtype,
                          device=device)
        # clipwise AudioSet logits (sigmoid'ed in the published model; kept
        # as logits for both the softmax-KL and the sigmoid-KL conventions)
        self.fc_audioset = Linear(cfg.embed_dim, cfg.num_classes, dtype=dtype,
                                  device=device)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        mel = pann_logmel(waveform, self.cfg)          # (b, t, m)
        # bn0 normalises across the mel bins: mels into the channel axis
        x = self.bn0(mel[:, :, :, None].transpose(1, 2))   # (b, m, t, 1)
        x = x.transpose(1, 3)                          # (b, 1, t, m)
        for blk in self.blocks:
            x = blk(x)
        x = x.mean(dim=3)                              # (b, c, t') mel-mean
        x = x.amax(dim=2) + x.mean(dim=2)              # time pooling
        return F.relu(self.fc1(x)).float()

    def logits(self, waveform: torch.Tensor) -> torch.Tensor:
        """(b, t) -> (b, num_classes) clipwise AudioSet logits (the
        published Cnn14's inference path, no dropout)."""
        return self.fc_audioset(self(waveform)).float()


def load_pann_from_state_dict(sd: dict, model: Cnn14) -> None:
    """A published ``Cnn14*.pth`` state dict (tensors or arrays) -> ``model``
    in place. The published keys are in PyTorch's layout already;
    ``conv_block{i}`` is ``blocks[i - 1]``. The tagging head is read when
    present. Other keys (the published front end's STFT and mel tables)
    are not used: the port computes its own."""
    from v2ap_torch.utils.convert import copy_state

    def put(dst: torch.Tensor, key: str) -> None:
        copy_state(dst, sd, key)

    def bn(mod: BatchNorm2d, key: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            put(getattr(mod, leaf), f"{key}.{leaf}")

    bn(model.bn0, "bn0")
    for i, blk in enumerate(model.blocks, start=1):
        p = f"conv_block{i}"
        put(blk.conv1.weight, f"{p}.conv1.weight")
        bn(blk.bn1, f"{p}.bn1")
        put(blk.conv2.weight, f"{p}.conv2.weight")
        bn(blk.bn2, f"{p}.bn2")
    put(model.fc1.weight, "fc1.weight")
    put(model.fc1.bias, "fc1.bias")
    if "fc_audioset.weight" in sd:
        put(model.fc_audioset.weight, "fc_audioset.weight")
        put(model.fc_audioset.bias, "fc_audioset.bias")


def _build_cnn14(cfg: PannConfig | None, weights_path: str | None, device):
    """Cnn14 on ``device`` from ``weights_path`` / ``$V2AP_PANN_WEIGHTS``
    (its ``model`` entry is the state dict), or from seed 0."""
    cfg = cfg or pann_16k()
    device = resolve_device(device)
    with seeded_init(0, device):
        model = Cnn14(cfg, device=device)
    weights_path = weights_path or os.environ.get("V2AP_PANN_WEIGHTS")
    if weights_path:
        ckpt = torch.load(weights_path, map_location="cpu")
        load_pann_from_state_dict(ckpt.get("model", ckpt), model)
    return cfg, model.eval().requires_grad_(False)


def _wrap_forward(cfg: PannConfig, model: Cnn14, method):
    device = next(model.parameters()).device

    @torch.inference_mode()
    def run(waveform: np.ndarray, sr: int):
        from v2ap_torch.data.audio_io import resample
        wav = np.atleast_2d(np.asarray(waveform, np.float32))
        if sr != cfg.sample_rate:
            wav = resample(wav, sr, cfg.sample_rate)
        out = method(model, torch.from_numpy(np.ascontiguousarray(wav)
                                             ).to(device))
        return (tuple(o.cpu().numpy() for o in out) if isinstance(out, tuple)
                else out.cpu().numpy())

    return run


def make_embedder(cfg: PannConfig | None = None,
                  weights_path: str | None = None, device=None):
    """``embed(waveform, sr) -> (n, embed_dim)`` for ``metrics.fad``."""
    cfg, model = _build_cnn14(cfg, weights_path, device)
    return _wrap_forward(cfg, model, lambda m, w: m(w))


def make_classifier(cfg: PannConfig | None = None,
                    weights_path: str | None = None, device=None):
    """``classify(waveform, sr) -> (n, num_classes)`` clipwise AudioSet
    logits for IS / KL (the embedder's checkpoint)."""
    cfg, model = _build_cnn14(cfg, weights_path, device)
    return _wrap_forward(cfg, model, lambda m, w: m.logits(w))


def make_joint(cfg: PannConfig | None = None,
               weights_path: str | None = None, device=None):
    """``joint(waveform, sr) -> (embeddings, logits)`` from ONE Cnn14 pass:
    the logits are one Linear past the embedding, so FAD + IS + KL take
    this rather than an embedder and a classifier."""
    cfg, model = _build_cnn14(cfg, weights_path, device)

    def both(m, w):
        emb = m(w)
        return emb, m.fc_audioset(emb).float()

    return _wrap_forward(cfg, model, both)
