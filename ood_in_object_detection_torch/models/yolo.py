"""YOLOv8 detector assembled from its layer spec (port of
ood_in_object_detection_tpu/models/yolo.py, v8 family only).

``YOLODetector.forward`` returns ``(raw_levels, neck_feats)``: the three raw
head maps (B, 4*16+nc, H, W) and the three PAN neck maps (B, C, H, W) that
feed the head (layers 15, 18, 21), which are the OoD feature taps. The
phase-folded stem of the JAX package is an exact rewrite of the first two
convs and is not ported: plain convs compute the same thing.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from . import layers as L
from .head import Detect

SPEC_V8 = [
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 3, "C2f", [128, True]),
    (-1, 1, "Conv", [256, 3, 2]),
    (-1, 6, "C2f", [256, True]),
    (-1, 1, "Conv", [512, 3, 2]),
    (-1, 6, "C2f", [512, True]),
    (-1, 1, "Conv", [1024, 3, 2]),
    (-1, 3, "C2f", [1024, True]),
    (-1, 1, "SPPF", [1024, 5]),
    (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []),
    (-1, 3, "C2f", [512]),
    (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []),
    (-1, 3, "C2f", [256]),  # 15 P3
    (-1, 1, "Conv", [256, 3, 2]),
    ([-1, 12], 1, "Concat", []),
    (-1, 3, "C2f", [512]),  # 18 P4
    (-1, 1, "Conv", [512, 3, 2]),
    ([-1, 9], 1, "Concat", []),
    (-1, 3, "C2f", [1024]),  # 21 P5
    ([15, 18, 21], 1, "Detect", []),
]

# scale -> (depth, width, max_channels); reference cfg/models/v8/yolov8.yaml
SCALES = {"yolov8": {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024),
                     "m": (0.67, 0.75, 768), "l": (1.00, 1.00, 512),
                     "x": (1.00, 1.25, 512)}}

# families of the JAX package that this port does not build yet
UNPORTED_FAMILIES = ("yolov9", "yolov10", "yolo11", "yolo12")


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class YOLODetector(nn.Module):
    """Spec interpreter for the v8 modules; ``self.model[i]`` is spec layer
    i, so parameters are named ``model.<i>.<...>`` as in ultralytics."""

    def __init__(self, spec: Sequence = SPEC_V8, nc: int = 80, depth: float = 1.0,
                 width: float = 1.0, max_channels: int = 512):
        super().__init__()
        self.nc = nc
        self.spec = [tuple(s) for s in spec]
        ch: List[int] = []  # output channels per layer
        layers = []
        for li, (frm, rep, mod, args) in enumerate(self.spec):
            c_in = 3 if li == 0 else ch[frm] if isinstance(frm, int) else None
            n = max(round(rep * depth), 1) if rep > 1 else rep
            if mod == "Conv":
                c2, k, s = self._ch(args[0], width, max_channels), args[1], args[2]
                layers.append(L.Conv(c_in, c2, k, s))
            elif mod == "C2f":
                c2 = self._ch(args[0], width, max_channels)
                layers.append(L.C2f(c_in, c2, n, args[1] if len(args) > 1 else False))
            elif mod == "SPPF":
                c2 = self._ch(args[0], width, max_channels)
                layers.append(L.SPPF(c_in, c2, args[1]))
            elif mod == "Upsample":
                c2 = c_in
                layers.append(L.Upsample())
            elif mod == "Concat":
                c2 = sum(ch[i] for i in frm)
                layers.append(L.Concat())
            elif mod == "Detect":
                self.neck_layers = tuple(frm)
                self.neck_channels = tuple(ch[i] for i in frm)
                c2 = 0
                layers.append(Detect(nc, self.neck_channels))
            else:
                raise NotImplementedError(
                    f"module {mod} is not ported yet (ROADMAP.md A8, the other YOLO families)")
            ch.append(c2)
        self.model = nn.ModuleList(layers)

    @staticmethod
    def _ch(c: int, width: float, max_channels: int) -> int:
        return make_divisible(min(c, max_channels) * width, 8)

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        ys: List[torch.Tensor] = []
        for (frm, _, mod, _), m in zip(self.spec, self.model):
            if mod == "Detect":
                neck = [ys[i] for i in frm]
                return m(neck), neck
            if mod == "Concat":
                x = m([x if i == -1 else ys[i] for i in frm])
            else:
                x = m(x if frm == -1 else ys[frm])
            ys.append(x)
        raise RuntimeError("spec did not terminate with a Detect layer")


def build_model(name: str, nc: int = 80) -> YOLODetector:
    """'yolov8n' .. 'yolov8x'; other families raise NotImplementedError."""
    if name.startswith("yolov8"):
        size = name[len("yolov8"):]
        if size not in SCALES["yolov8"]:
            raise ValueError(f"unknown size '{size}' for yolov8; have {list(SCALES['yolov8'])}")
        depth, width, max_ch = SCALES["yolov8"][size]
        return YOLODetector(SPEC_V8, nc=nc, depth=depth, width=width, max_channels=max_ch)
    if name.startswith(UNPORTED_FAMILIES):
        raise NotImplementedError(
            f"{name}: only yolov8 is ported so far (ROADMAP.md A8, the other YOLO families)")
    raise ValueError(f"unknown model name {name}")


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init matching the JAX package's: conv weights U(+-1/sqrt(fan_in))
    (torch Conv2d's default), BatchNorm identity, head biases per bias_init."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d) and m.weight.requires_grad:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                    -bound, bound, generator=generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, Detect):
                m.bias_init()
