"""Plain float32 reference of Video2Roll (ResNet18 + FPN piano perception):
5 stacked grayscale keyboard strips (5, 100, 900) -> per-key logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.nn import BatchNorm2d, Conv2d, Linear


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, bias=False, *,
                 device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=pad,
                           bias=bias, device=device)
        self.bn = BatchNorm2d(cout, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, *, device=None):
        super().__init__()
        self.cb1 = ConvBN(cin, cout, 3, stride, 1, device=device)
        self.cb2 = ConvBN(cout, cout, 3, 1, 1, device=device)
        self.down = (ConvBN(cin, cout, 1, stride, 0, device=device)
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        res = x if self.down is None else self.down(x)
        return F.relu(self.cb2(F.relu(self.cb1(x))) + res)


class FTB(nn.Module):
    def __init__(self, cin, cout, *, device=None):
        super().__init__()
        self.conv0 = Conv2d(cin, cout, 1, padding=1, bias=False, device=device)
        self.cb1 = ConvBN(cout, cout, 3, 1, 1, device=device)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False,
                            device=device)

    def forward(self, x, avg=True):
        x1 = self.conv0(x)
        h = self.conv2(F.relu(self.cb1(x1))) + x1
        return F.avg_pool2d(h, 2, 2) if avg else F.avg_pool2d(h, 3, 1)


class FRB(nn.Module):
    def __init__(self, ch_h, ch_l, *, device=None):
        super().__init__()
        self.fc1 = Linear(ch_h + ch_l, ch_l, device=device)
        self.fc2 = Linear(ch_l, ch_l, device=device)

    def forward(self, xl, xh):
        z = torch.cat([xl, xh], 1).mean(dim=(2, 3))
        return xl * torch.sigmoid(self.fc2(F.relu(self.fc1(z))))[:, :, None,
                                                                   None]


class Video2RollNet(nn.Module):
    def __init__(self, num_classes=51, in_frames=5, *, device=None):
        super().__init__()
        p = dict(device=device)
        self.stem = ConvBN(in_frames, 64, 11, 2, 4, **p)

        def stage(cin, cout, stride):
            return nn.ModuleList([BasicBlock(cin, cout, stride, **p),
                                  BasicBlock(cout, cout, 1, **p)])

        self.layer1 = stage(64, 64, 1)
        self.layer2 = stage(64, 128, 2)
        self.layer3 = stage(128, 256, 2)
        self.layer4 = stage(256, 512, 2)
        self.ftb2_1 = FTB(128, 128, **p)
        self.ftb2_2 = FTB(128, 128, **p)
        self.ftb3 = FTB(256, 128, **p)
        self.ftb4 = FTB(512, 128, **p)
        self.toplayer = ConvBN(512, 64, 1, 1, 0, bias=True, **p)
        self.frb4 = FRB(64, 128, **p)
        self.frb3 = FRB(128, 128, **p)
        self.frb2 = FRB(128, 128, **p)
        self.conv2 = Conv2d(128, 128, 1, **p)
        self.fc = Linear(128, num_classes, **p)

    def forward(self, x):
        h = F.relu(self.stem(x))
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=float("-inf")), 3, 2)
        for blk in self.layer1:
            h = blk(h)
        x2 = h
        for blk in self.layer2:
            x2 = blk(x2)
        x3 = x2
        for blk in self.layer3:
            x3 = blk(x3)
        x4 = x3
        for blk in self.layer4:
            x4 = blk(x4)
        x5 = F.relu(self.toplayer(x4))
        p4 = self.frb4(self.ftb4(x4, avg=False), x5)
        p3 = self.frb3(self.ftb3(x3), p4)
        p2 = self.frb2(self.ftb2_2(self.ftb2_1(x2)), p3)
        out1 = p2 * p3
        att = torch.softmax(out1.flatten(2), dim=-1).view(out1.shape)
        out = self.conv2(att * p4) + p4
        return self.fc(out.mean(dim=(2, 3)))
