"""Video2Roll piano-perception network (ResNet18 + FPN), NCHW.

Counterpart of ``v2ap_tpu/models/video2roll.py``: 5 stacked grayscale
keyboard frames (5, 100, 900) -> ``num_classes`` key logits.

  11x11/2 stem -> 3x3/2 max-pool (pads with -inf) -> 4 BasicBlock stages
  -> feature-transform blocks (FTB: a 1x1 conv with padding 1, which grows
     H and W by 2, a residual 3x3 pair, a VALID average pool 2/2 or 3/1)
     aligning stages 2-4 to one 4x29 grid
  -> feature-refinement gates (FRB: squeeze-excite over concat(xl, xh))
  -> p2 * p3, a softmax over H*W per channel in float32, * p4 -> 1x1 conv
  -> global mean -> fc, logits in float32.

The JAX package leaves these convolutions to XLA, outside Pallas, so here
they are ``torch.nn.functional.conv2d``. Convolutions compute in the model's
dtype; BatchNorm computes in float32, as ``nnx.BatchNorm(dtype=float32)``
does, on its running statistics unless ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.ops.layers import BatchNorm2d, Conv2d, Linear
from v2ap_torch.utils.device import resolve_device


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, use_bias=False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=pad,
                           bias=use_bias, dtype=dtype, device=device)
        self.bn = BatchNorm2d(cout, device=device)

    def forward(self, x, train: bool = False):
        return self.bn(self.conv(x), train)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cb1 = ConvBN(cin, cout, 3, stride, 1, **kw)
        self.cb2 = ConvBN(cout, cout, 3, 1, 1, **kw)
        self.down = (ConvBN(cin, cout, 1, stride, 0, **kw)
                     if (stride != 1 or cin != cout) else None)

    def forward(self, x, train: bool = False):
        res = self.down(x, train) if self.down is not None else x
        h = F.relu(self.cb1(x, train))
        return F.relu(self.cb2(h, train) + res)


class FTB(nn.Module):
    """Feature-transform block: 1x1 conv with padding 1 (H and W grow by 2),
    residual 3x3 pair with BN, then a VALID average pool (2/2 when ``avg``,
    else 3/1)."""

    def __init__(self, cin, cout, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv2d(cin, cout, 1, padding=1, bias=False, **kw)
        self.cb1 = ConvBN(cout, cout, 3, 1, 1, **kw)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False, **kw)

    def forward(self, x, avg: bool = True, train: bool = False):
        x1 = self.conv0(x)
        h = F.relu(self.cb1(x1, train))
        h = self.conv2(h) + x1
        return F.avg_pool2d(h, 2, 2) if avg else F.avg_pool2d(h, 3, 1)


class FRB(nn.Module):
    """Feature-refine block: squeeze-excite gate over concat(xl, xh) -> xl."""

    def __init__(self, ch_h, ch_l, *, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Linear(ch_h + ch_l, ch_l, dtype=dtype, device=device)
        self.fc2 = Linear(ch_l, ch_l, dtype=dtype, device=device)

    def forward(self, xl, xh):
        dt = torch.promote_types(xl.dtype, xh.dtype)
        z = torch.cat([xl.to(dt), xh.to(dt)], dim=1).mean(dim=(2, 3))
        z = torch.sigmoid(self.fc2(F.relu(self.fc1(z))))
        return xl * z[:, :, None, None]


class Video2RollNet(nn.Module):
    def __init__(self, num_classes: int = 51, in_frames: int = 5, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.stem = ConvBN(in_frames, 64, 11, 2, 4, **kw)

        def mk(cin, cout, stride):
            return nn.ModuleList([BasicBlock(cin, cout, stride, **kw),
                                  BasicBlock(cout, cout, 1, **kw)])

        self.layer1 = mk(64, 64, 1)
        self.layer2 = mk(64, 128, 2)
        self.layer3 = mk(128, 256, 2)
        self.layer4 = mk(256, 512, 2)

        self.ftb2_1 = FTB(128, 128, **kw)
        self.ftb2_2 = FTB(128, 128, **kw)
        self.ftb3 = FTB(256, 128, **kw)
        self.ftb4 = FTB(512, 128, **kw)

        self.toplayer = ConvBN(512, 64, 1, 1, 0, use_bias=True, **kw)
        self.frb4 = FRB(64, 128, **kw)
        self.frb3 = FRB(128, 128, **kw)
        self.frb2 = FRB(128, 128, **kw)

        self.conv2 = Conv2d(128, 128, 1, **kw)
        self.fc = Linear(128, num_classes, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (b, frames=5, H, W) grayscale stack -> (b, num_classes) f32
        logits. ``train=True`` normalises with the batch statistics and
        updates the running ones (the standalone Video2Roll trainer); the
        CFM runs it on the running statistics, in training too."""
        h = F.relu(self.stem(x.to(self.dtype), train))
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=float("-inf")), 3, 2)
        for blk in self.layer1:
            h = blk(h, train)
        x2 = h
        for blk in self.layer2:
            x2 = blk(x2, train)
        x3 = x2
        for blk in self.layer3:
            x3 = blk(x3, train)
        x4 = x3
        for blk in self.layer4:
            x4 = blk(x4, train)

        x5 = F.relu(self.toplayer(x4, train))
        x2_ = self.ftb2_2(self.ftb2_1(x2, train=train), train=train)
        x3_ = self.ftb3(x3, train=train)
        x4_ = self.ftb4(x4, avg=False, train=train)

        p4 = self.frb4(x4_, x5)
        p3 = self.frb3(x3_, p4)
        p2 = self.frb2(x2_, p3)

        out1 = p2 * p3
        att = torch.softmax(out1.flatten(2).float(), dim=-1
                            ).view(out1.shape).to(out1.dtype)
        out = self.conv2(att * p4) + p4
        return self.fc(out.mean(dim=(2, 3))).float()


def upsample_strips_2x(x: torch.Tensor) -> torch.Tensor:
    """Linear 2x upsample along the key axis (the last dim): the device side
    of the strip-half shipping mode (``data.video_io.pack_strips_half``
    packs on the host). Output j reads source position (j + 0.5) / 2 - 0.5,
    edge-clamped, as the JAX package's."""
    w2 = x.shape[-1]
    pos = ((torch.arange(2 * w2, device=x.device, dtype=torch.float32)
            + 0.5) / 2.0 - 0.5).clamp(0.0, w2 - 1.0)
    i0 = pos.floor().long()
    i1 = (i0 + 1).clamp(max=w2 - 1)
    w = (pos - i0).to(x.dtype)
    return x[..., i0] * (1.0 - w) + x[..., i1] * w
