"""YOLOv8 layers as PyTorch modules (NCHW).

Port of ood_in_object_detection_tpu/models/layers.py (Conv, Bottleneck, C2f,
SPPF, max-pool, upsample); reference ultralytics nn/modules/{conv,block}.py.
Module and attribute names follow ultralytics, so the state_dict that
``utils/weight_import.py:export_state_dict`` writes from the JAX variables
loads here with ``strict=True`` and no renaming table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d(eps=1e-3) + SiLU, padding k // 2."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, fast (reference block.py C2f)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, k=(3, 3), e=1.0)
                               for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast; the max-pool pads with -inf."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(self.m(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Concat(nn.Module):
    """Concatenate on channels (the inputs are chosen by the spec)."""

    def forward(self, xs):
        return torch.cat(xs, dim=1)
