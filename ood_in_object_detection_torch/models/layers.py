"""YOLOv8 layers as PyTorch modules (NCHW).

Port of ood_in_object_detection_tpu/models/layers.py (Conv, Bottleneck, C2f,
SPPF, max-pool, upsample); reference ultralytics nn/modules/{conv,block}.py.
Module and attribute names follow ultralytics, so the state_dict that
``utils/weight_import.py:export_state_dict`` writes from the JAX variables
loads here with ``strict=True`` and no renaming table.

Compute dtype: every layer computes in the dtype of its input, and the model
casts the image once (models/yolo.py). Parameters stay f32; a bf16 input is
the JAX package's ``dtype=bf16`` (flax Conv and BatchNorm, layers.py:43-79):
the conv runs on bf16 operands and returns bf16, inference BN computes in
f32 from the bf16 conv output and rounds to bf16, SiLU rounds at each of
its ops, as jax.nn.silu does (ops/stem.py:silu). The weights are cast at
each call, as flax promotes its f32 params at each call: no cached copy can
go stale when weights are loaded or calibrated after the model is built,
and the cast is a small share of a conv's time. ``torch.autocast`` is not
used, since it rounds at other points than flax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stem import silu

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``x`` in x's dtype, its f32 weight (and bias) cast to it;
    the bias is added after the conv's result is rounded, as flax does."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)[:, None, None]


def bn_inference(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax BatchNorm(dtype=x.dtype) at inference: ``(x - mean) * (scale *
    rsqrt(var + eps)) + bias`` in f32 on the running statistics, rounded to
    x's dtype."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    y = (x.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
    return (y + bn.bias[:, None, None]).to(x.dtype)


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d(eps=1e-3) + SiLU, padding k // 2."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x):
        if x.dtype == torch.float32:
            x = self.bn(self.conv(x))
        else:
            x = bn_inference(self.bn, conv_in_dtype(self.conv, x))
        return silu(x) if self.act else x


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
