"""YOLOv8 detector assembled from its layer spec (port of
ood_in_object_detection_tpu/models/yolo.py, v8 family only).

``YOLODetector.forward`` returns ``(raw_levels, neck_feats)``: the three raw
head maps (B, 4*16+nc, H, W) and the three PAN neck maps (B, C, H, W) that
feed the head (layers 15, 18, 21), which are the OoD feature taps, in the
model's compute ``dtype`` (f32 or bf16; parameters stay f32).

At inference the first two k3/s2 Conv blocks run as one fused stem
(ops/stem.py:fused_stem, kernel K4 on the card) on layers 0 and 1's own
parameters, as the JAX model runs its phase-folded stem (yolo.py:398-431);
``folded_stem=False``, and every training-mode forward, keep the two Conv
modules.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.stem import fused_stem
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
                 width: float = 1.0, max_channels: int = 512, folded_stem: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.nc = nc
        self.folded_stem = folded_stem
        self.compute_dtype = dtype
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

    def _can_fold_stem(self, x: torch.Tensor) -> bool:
        """The JAX model's gate (yolo.py:398-410): inference only; layers 0
        and 1 are Conv(., 3, 2); H and W multiples of 4; no later layer reads
        layer 0 or 1."""
        if self.training or not self.folded_stem or len(self.spec) < 3:
            return False
        if any(mod != "Conv" or list(args[1:]) != [3, 2] for _, _, mod, args in self.spec[:2]):
            return False
        if x.shape[2] % 4 or x.shape[3] % 4:
            return False
        for frm, _, _, _ in self.spec[2:]:
            refs = frm if isinstance(frm, (list, tuple)) else [frm]
            if any(r in (0, 1) for r in refs):
                return False
        return True

    def forward(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if self.training and self.compute_dtype != torch.float32:
            raise NotImplementedError("training runs in f32: bf16 training is not ported")
        x = x.to(self.compute_dtype)  # after normalisation, as yolo.py:416
        ys: List[torch.Tensor] = []
        start = 0
        if self._can_fold_stem(x):
            x = fused_stem(x, self.model[0], self.model[1], self.compute_dtype)
            ys.extend([x, x])  # ys[0] is never read (checked by _can_fold_stem)
            start = 2
        for li, ((frm, _, mod, _), m) in enumerate(zip(self.spec, self.model)):
            if li < start:
                continue
            if mod == "Detect":
                neck = [ys[i] for i in frm]
                return m(neck), neck
            if mod == "Concat":
                x = m([x if i == -1 else ys[i] for i in frm])
            else:
                x = m(x if frm == -1 else ys[frm])
            ys.append(x)
        raise RuntimeError("spec did not terminate with a Detect layer")


def build_model(name: str, nc: int = 80, dtype: torch.dtype = torch.float32,
                folded_stem: bool = True) -> YOLODetector:
    """'yolov8n' .. 'yolov8x' computing in ``dtype``; other families raise
    NotImplementedError."""
    if name.startswith("yolov8"):
        size = name[len("yolov8"):]
        if size not in SCALES["yolov8"]:
            raise ValueError(f"unknown size '{size}' for yolov8; have {list(SCALES['yolov8'])}")
        depth, width, max_ch = SCALES["yolov8"][size]
        return YOLODetector(SPEC_V8, nc=nc, depth=depth, width=width, max_channels=max_ch,
                            folded_stem=folded_stem, dtype=dtype)
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
