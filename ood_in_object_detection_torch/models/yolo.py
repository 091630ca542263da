"""YOLO detectors (v8, v9, v10, 11, 12 at every scale) assembled from their
layer specs (port of ood_in_object_detection_tpu/models/yolo.py).

``YOLODetector.forward`` returns ``(raw_levels, neck_feats)``: the three raw
head maps (B, 4*16+nc, H, W) and the three PAN neck maps (B, C, H, W) that
feed the head, which are the OoD feature taps, in the model's compute
``dtype`` (f32 or bf16; parameters stay f32). yolov10's raw maps are its
one2one maps (the inference path); in training it returns a third element,
the one2many maps, as the JAX model does (yolo.py:436-452).

At inference the first two k3/s2 Conv blocks run as one fused stem
(ops/stem.py:fused_stem, kernel K4 on the card) on layers 0 and 1's own
parameters, as the JAX model runs its phase-folded stem (yolo.py:398-431),
wherever the spec allows it, as the JAX model's gate does
(:attr:`YOLODetector.stem_route`); ``folded_stem=False``, and every
training-mode forward, keep the two Conv modules. On a shard of an ``sp``
group (parallel/spatial.py) the forward runs unchanged on a slab of the
image's rows, K4 included, and the layers exchange their halos. A training
rank's slab (spatial.RankShard) returns the raw maps gathered whole, for
the loss: each rank's gradient flows back through its own rows alone, the
neck maps as its rows.

Training runs in f32 or in bf16 (f32 parameters, bf16 compute, as the JAX
package's ``--dtype bfloat16``), with flax's BatchNorm (models/layers.py:
bn_train). With ``remat`` set, a training forward that records gradients
runs every layer under ``torch.utils.checkpoint``: only the layers' outputs
are kept for the backward, as the JAX trainer's ``save_only_these_names(
"layer_out")`` keeps only the per-layer tags (yolo.py:564-569).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.stem import fused_stem
from ..parallel import spatial
from . import layers as L
from .head import Detect


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


# Copies of the JAX package's specs and scale tables (models/yolo.py:29-353).
# (from, repeats, module, args) — args follow the reference YAML conventions
# (ultralytics/cfg/models/*). "Detect" terminates the spec; its `from` lists
# the neck taps that are also returned as OoD feature maps.
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

SPEC_V9C = [
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 1, "RepNCSPELAN4", [256, 128, 64, 1]),
    (-1, 1, "ADown", [256]),
    (-1, 1, "RepNCSPELAN4", [512, 256, 128, 1]),
    (-1, 1, "ADown", [512]),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 1]),
    (-1, 1, "ADown", [512]),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 1]),
    (-1, 1, "SPPELAN", [512, 256]),
    (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 1]),
    (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [256, 256, 128, 1]),  # 15 P3
    (-1, 1, "ADown", [256]),
    ([-1, 12], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 1]),  # 18 P4
    (-1, 1, "ADown", [512]),
    ([-1, 9], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 1]),  # 21 P5
    ([15, 18, 21], 1, "Detect", []),
]

SPEC_V10L = [
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 3, "C2f", [128, True]),
    (-1, 1, "Conv", [256, 3, 2]),
    (-1, 6, "C2f", [256, True]),
    (-1, 1, "SCDown", [512, 3, 2]),
    (-1, 6, "C2f", [512, True]),
    (-1, 1, "SCDown", [1024, 3, 2]),
    (-1, 3, "C2fCIB", [1024, True]),
    (-1, 1, "SPPF", [1024, 5]),
    (-1, 1, "PSA", [1024]),
    (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []),
    (-1, 3, "C2fCIB", [512, True]),
    (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []),
    (-1, 3, "C2f", [256]),  # 16 P3
    (-1, 1, "Conv", [256, 3, 2]),
    ([-1, 13], 1, "Concat", []),
    (-1, 3, "C2fCIB", [512, True]),  # 19 P4
    (-1, 1, "SCDown", [512, 3, 2]),
    ([-1, 10], 1, "Concat", []),
    (-1, 3, "C2fCIB", [1024, True]),  # 22 P5
    ([16, 19, 22], 1, "Detect", []),
]

SPEC_V11 = [
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 2, "C3k2", [256, False, 0.25]),
    (-1, 1, "Conv", [256, 3, 2]),
    (-1, 2, "C3k2", [512, False, 0.25]),
    (-1, 1, "Conv", [512, 3, 2]),
    (-1, 2, "C3k2", [512, True]),
    (-1, 1, "Conv", [1024, 3, 2]),
    (-1, 2, "C3k2", [1024, True]),
    (-1, 1, "SPPF", [1024, 5]),
    (-1, 2, "C2PSA", [1024]),
    (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []),
    (-1, 2, "C3k2", [512, False]),
    (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []),
    (-1, 2, "C3k2", [256, False]),  # 16 P3
    (-1, 1, "Conv", [256, 3, 2]),
    ([-1, 13], 1, "Concat", []),
    (-1, 2, "C3k2", [512, False]),  # 19 P4
    (-1, 1, "Conv", [512, 3, 2]),
    ([-1, 10], 1, "Concat", []),
    (-1, 2, "C3k2", [1024, True]),  # 22 P5
    ([16, 19, 22], 1, "Detect", []),
]

SPEC_V12 = [
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 2, "C3k2", [256, False, 0.25]),
    (-1, 1, "Conv", [256, 3, 2]),
    (-1, 2, "C3k2", [512, False, 0.25]),
    (-1, 1, "Conv", [512, 3, 2]),
    (-1, 4, "A2C2f", [512, True, 4]),
    (-1, 1, "Conv", [1024, 3, 2]),
    (-1, 4, "A2C2f", [1024, True, 1]),
    (-1, 1, "Upsample", []),
    ([-1, 6], 1, "Concat", []),
    (-1, 2, "A2C2f", [512, False, -1]),
    (-1, 1, "Upsample", []),
    ([-1, 4], 1, "Concat", []),
    (-1, 2, "A2C2f", [256, False, -1]),  # 14 P3
    (-1, 1, "Conv", [256, 3, 2]),
    ([-1, 11], 1, "Concat", []),
    (-1, 2, "A2C2f", [512, False, -1]),  # 17 P4
    (-1, 1, "Conv", [512, 3, 2]),
    ([-1, 8], 1, "Concat", []),
    (-1, 2, "C3k2", [1024, True]),  # 20 P5
    ([14, 17, 20], 1, "Detect", []),
]

def _spec_v9_gelan(widths, elan1_first: bool, rep_n: int):
    """GELAN spec template for yolov9 t/s/m (reference cfg/models/v9/*.yaml).
    widths = per-slot channel table (stem0, stem1, b2(c2,c3,c4), p3, b4, p4,
    b6, p5, b8, sppelan, head blocks ...)."""
    w = widths
    first = ("ELAN1", [w["b2"][0], w["b2"][1], w["b2"][2]]) if elan1_first else \
        ("RepNCSPELAN4", [w["b2"][0], w["b2"][1], w["b2"][2], rep_n])
    return [
        (-1, 1, "Conv", [w["s0"], 3, 2]),
        (-1, 1, "Conv", [w["s1"], 3, 2]),
        (-1, 1, first[0], first[1]),
        (-1, 1, "AConv", [w["p3"]]),
        (-1, 1, "RepNCSPELAN4", [w["b4"][0], w["b4"][1], w["b4"][2], rep_n]),
        (-1, 1, "AConv", [w["p4"]]),
        (-1, 1, "RepNCSPELAN4", [w["b6"][0], w["b6"][1], w["b6"][2], rep_n]),
        (-1, 1, "AConv", [w["p5"]]),
        (-1, 1, "RepNCSPELAN4", [w["b8"][0], w["b8"][1], w["b8"][2], rep_n]),
        (-1, 1, "SPPELAN", [w["spp"][0], w["spp"][1]]),
        (-1, 1, "Upsample", []),
        ([-1, 6], 1, "Concat", []),
        (-1, 1, "RepNCSPELAN4", [w["b6"][0], w["b6"][1], w["b6"][2], rep_n]),
        (-1, 1, "Upsample", []),
        ([-1, 4], 1, "Concat", []),
        (-1, 1, "RepNCSPELAN4", [w["b4"][0], w["b4"][1], w["b4"][2], rep_n]),
        (-1, 1, "AConv", [w["b6"][2]]),
        ([-1, 12], 1, "Concat", []),
        (-1, 1, "RepNCSPELAN4", [w["b6"][0], w["b6"][1], w["b6"][2], rep_n]),
        (-1, 1, "AConv", [w["b8"][2]]),
        ([-1, 9], 1, "Concat", []),
        (-1, 1, "RepNCSPELAN4", [w["b8"][0], w["b8"][1], w["b8"][2], rep_n]),
        ([15, 18, 21], 1, "Detect", []),
    ]


SPEC_V9T = _spec_v9_gelan(
    dict(s0=16, s1=32, b2=(32, 32, 16), p3=64, b4=(64, 64, 32), p4=96,
         b6=(96, 96, 48), p5=128, b8=(128, 128, 64), spp=(128, 64)),
    elan1_first=True, rep_n=3)
SPEC_V9S = _spec_v9_gelan(
    dict(s0=32, s1=64, b2=(64, 64, 32), p3=128, b4=(128, 128, 64), p4=192,
         b6=(192, 192, 96), p5=256, b8=(256, 256, 128), spp=(256, 128)),
    elan1_first=True, rep_n=3)
SPEC_V9M = _spec_v9_gelan(
    dict(s0=32, s1=64, b2=(128, 128, 64), p3=240, b4=(240, 240, 120), p4=360,
         b6=(360, 360, 180), p5=480, b8=(480, 480, 240), spp=(480, 240)),
    elan1_first=False, rep_n=1)


SPEC_V9E = [
    (-1, 1, "Identity", []),
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 1, "RepNCSPELAN4", [256, 128, 64, 2]),
    (-1, 1, "ADown", [256]),
    (-1, 1, "RepNCSPELAN4", [512, 256, 128, 2]),
    (-1, 1, "ADown", [512]),
    (-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]),
    (-1, 1, "ADown", [1024]),
    (-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]),
    (1, 1, "CBLinear", [[64]]),
    (3, 1, "CBLinear", [[64, 128]]),
    (5, 1, "CBLinear", [[64, 128, 256]]),
    (7, 1, "CBLinear", [[64, 128, 256, 512]]),
    (9, 1, "CBLinear", [[64, 128, 256, 512, 1024]]),
    (0, 1, "Conv", [64, 3, 2]),
    ([10, 11, 12, 13, 14, -1], 1, "CBFuse", [[0, 0, 0, 0, 0]]),
    (-1, 1, "Conv", [128, 3, 2]),
    ([11, 12, 13, 14, -1], 1, "CBFuse", [[1, 1, 1, 1]]),
    (-1, 1, "RepNCSPELAN4", [256, 128, 64, 2]),
    (-1, 1, "ADown", [256]),
    ([12, 13, 14, -1], 1, "CBFuse", [[2, 2, 2]]),
    (-1, 1, "RepNCSPELAN4", [512, 256, 128, 2]),
    (-1, 1, "ADown", [512]),
    ([13, 14, -1], 1, "CBFuse", [[3, 3]]),
    (-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]),
    (-1, 1, "ADown", [1024]),
    ([14, -1], 1, "CBFuse", [[4]]),
    (-1, 1, "RepNCSPELAN4", [1024, 512, 256, 2]),
    (-1, 1, "SPPELAN", [512, 256]),
    (-1, 1, "Upsample", []),
    ([-1, 25], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 2]),
    (-1, 1, "Upsample", []),
    ([-1, 22], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [256, 256, 128, 2]),  # 35 P3
    (-1, 1, "ADown", [256]),
    ([-1, 32], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [512, 512, 256, 2]),  # 38 P4
    (-1, 1, "ADown", [512]),
    ([-1, 29], 1, "Concat", []),
    (-1, 1, "RepNCSPELAN4", [512, 1024, 512, 2]),  # 41 P5
    ([35, 38, 41], 1, "Detect", []),
]


def _spec_v10(scale: str):
    """v10 spec per scale: scales differ only in which blocks are C2fCIB and
    the long-kernel flag (reference cfg/models/v10/yolov10{n,s,m,b,l,x}.yaml)."""
    cib = {
        "n": {8: (False, False), 13: (False, False), 19: (False, False), 22: (True, True)},
        "s": {8: (True, True), 13: (False, False), 19: (False, False), 22: (True, True)},
        "m": {8: (True, False), 13: (False, False), 19: (True, False), 22: (True, False)},
        "b": {8: (True, False), 13: (True, False), 19: (True, False), 22: (True, False)},
        "l": {8: (True, False), 13: (True, False), 19: (True, False), 22: (True, False)},
        "x": {6: (True, False), 8: (True, False), 13: (True, False), 19: (True, False), 22: (True, False)},
    }[scale]

    def blk(idx, c, shortcut=True):
        use_cib, lk = cib.get(idx, (False, False))
        if use_cib:
            return ("C2fCIB", [c, True, lk])
        return ("C2f", [c] + ([True] if shortcut else []))

    b6 = blk(6, 512)
    b8 = blk(8, 1024)
    b13 = blk(13, 512, shortcut=cib.get(13, (False,))[0])
    b19 = blk(19, 512, shortcut=cib.get(19, (False,))[0])
    b22 = blk(22, 1024)
    return [
        (-1, 1, "Conv", [64, 3, 2]),
        (-1, 1, "Conv", [128, 3, 2]),
        (-1, 3, "C2f", [128, True]),
        (-1, 1, "Conv", [256, 3, 2]),
        (-1, 6, "C2f", [256, True]),
        (-1, 1, "SCDown", [512, 3, 2]),
        (-1, 6, b6[0], b6[1]),
        (-1, 1, "SCDown", [1024, 3, 2]),
        (-1, 3, b8[0], b8[1]),
        (-1, 1, "SPPF", [1024, 5]),
        (-1, 1, "PSA", [1024]),
        (-1, 1, "Upsample", []),
        ([-1, 6], 1, "Concat", []),
        (-1, 3, b13[0], b13[1]),
        (-1, 1, "Upsample", []),
        ([-1, 4], 1, "Concat", []),
        (-1, 3, "C2f", [256]),
        (-1, 1, "Conv", [256, 3, 2]),
        ([-1, 13], 1, "Concat", []),
        (-1, 3, b19[0], b19[1]),
        (-1, 1, "SCDown", [512, 3, 2]),
        ([-1, 10], 1, "Concat", []),
        (-1, 3, b22[0], b22[1]),
        ([16, 19, 22], 1, "Detect", []),
    ]


# scale -> (depth, width, max_channels); reference cfg/models/*/*.yaml
SCALES = {
    "yolov8": {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)},
    "yolo11": {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)},
    "yolo12": {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)},
    "yolov9": {"c": (1.00, 1.00, 512)},
    "yolov10": {"l": (1.00, 1.00, 512)},
}
# per-file v9 variants (no compound scaling) and per-scale v10 specs register
# as their own spec keys with an empty size suffix
_V10_SCALES = {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024),
               "m": (0.67, 0.75, 768), "b": (0.67, 1.00, 512),
               "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)}

SPECS = {
    "yolov8": SPEC_V8,
    "yolov9t": SPEC_V9T,
    "yolov9s": SPEC_V9S,
    "yolov9m": SPEC_V9M,
    "yolov9e": SPEC_V9E,
    "yolov9": SPEC_V9C,
    "yolov10": SPEC_V10L,
    "yolo11": SPEC_V11,
    "yolo12": SPEC_V12,
}
for _s, _sc in _V10_SCALES.items():
    SPECS[f"yolov10{_s}"] = _spec_v10(_s)
for _k in ("yolov9t", "yolov9s", "yolov9m", "yolov9e"):
    SCALES[_k] = {"": (1.00, 1.00, 10 ** 9)}
for _s, _sc in _V10_SCALES.items():
    SCALES[f"yolov10{_s}"] = {"": _sc}

HEAD_STYLE = {"yolov8": "v8", "yolov9": "v8", "yolov10": "v10", "yolo11": "v11", "yolo12": "v12"}
for _k in ("yolov9t", "yolov9s", "yolov9m", "yolov9e"):
    HEAD_STYLE[_k] = "v8"
for _s in _V10_SCALES:
    HEAD_STYLE[f"yolov10{_s}"] = "v10"

# modules whose repeats column becomes the inner block count n
_REPEAT_AS_N = {"C2f", "C3k2", "C2fCIB", "C2PSA", "A2C2f"}

# modules of one input and one output, built from (c_in, width-scaled
# args[0], the other args as given)
_SIMPLE = {"SPPF": L.SPPF, "SCDown": L.SCDown, "PSA": L.PSA, "ADown": L.ADown,
           "AConv": L.AConv, "RepNCSPELAN4": L.RepNCSPELAN4, "ELAN1": L.ELAN1,
           "SPPELAN": L.SPPELAN}


class YOLODetector(nn.Module):
    """Spec interpreter; ``self.model[i]`` is spec layer i, so parameters
    are named ``model.<i>.<...>`` as in ultralytics, the Detect layer's
    index being :attr:`detect_layer_idx`.

    ``head_style`` is the Detect head's ("v10" is the dual head);
    ``attn_residual`` gives A2C2f its gamma residual and MLP ratio 1.2
    (yolo12 l/x); ``c3k_force`` runs every C3k2 with C3k blocks (yolo11/12
    m/l/x, reference nn/tasks.py:1495-1497)."""

    def __init__(self, spec: Sequence = SPEC_V8, nc: int = 80, depth: float = 1.0,
                 width: float = 1.0, max_channels: int = 512, head_style: str = "v8",
                 attn_residual: bool = False, c3k_force: bool = False,
                 folded_stem: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        self.nc = nc
        self.folded_stem = folded_stem
        self.compute_dtype = dtype
        self.remat = False  # checkpoint each layer in a training forward
        self.spec = [tuple(s) for s in spec]
        self.detect_layer_idx = len(self.spec) - 1

        def ch_(c):
            return make_divisible(min(c, max_channels) * width, 8)

        ch: List = []  # output channels per layer (a list for CBLinear)
        layers = []
        for li, (frm, rep, mod, args) in enumerate(self.spec):
            c_in = 3 if li == 0 else ch[frm] if isinstance(frm, int) else None
            n = max(round(rep * depth), 1) if rep > 1 else rep
            if mod in _REPEAT_AS_N:
                c2 = ch_(args[0])
                if mod == "C2f":
                    m = L.C2f(c_in, c2, n, args[1] if len(args) > 1 else False)
                elif mod == "C3k2":
                    m = L.C3k2(c_in, c2, n, c3k_force or (args[1] if len(args) > 1 else False),
                               e=args[2] if len(args) > 2 else 0.5)
                elif mod == "C2fCIB":
                    m = L.C2fCIB(c_in, c2, n, args[1] if len(args) > 1 else False,
                                 lk=args[2] if len(args) > 2 else False)
                elif mod == "C2PSA":
                    m = L.C2PSA(c_in, c2, n)
                else:  # A2C2f
                    a2 = args[1] if len(args) > 1 else True
                    area = args[2] if len(args) > 2 else 1
                    m = L.A2C2f(c_in, c2, n, a2, 1 if area in (-1, None) else area,
                                residual=attn_residual and a2,
                                mlp_ratio=1.2 if attn_residual else 2.0)
            elif mod == "Conv":
                c2 = ch_(args[0])
                m = L.Conv(c_in, c2, args[1], args[2])
            elif mod in _SIMPLE:
                # only args[0] is width-scaled (parse_model's c2): v9's c3, c4
                # pass as given, so v9m's 180 stays 180
                c2 = ch_(args[0])
                m = _SIMPLE[mod](c_in, c2, *args[1:])
            elif mod in ("Upsample", "Identity"):
                c2 = c_in
                m = L.Upsample() if mod == "Upsample" else nn.Identity()
            elif mod == "Concat":
                c2 = sum(ch[i] for i in frm)
                m = L.Concat()
            elif mod == "CBLinear":
                c2 = [ch_(c) for c in args[0]]
                m = L.CBLinear(c_in, c2)
            elif mod == "CBFuse":
                c2 = ch[frm[-1]]
                m = L.CBFuse(args[0])
            elif mod == "Detect":
                self.neck_layers = tuple(frm)
                self.neck_channels = tuple(ch[i] for i in frm)
                c2 = 0
                m = Detect(nc, self.neck_channels, head_style)
            else:
                raise ValueError(f"unknown module {mod}")
            layers.append(m)
            ch.append(c2)
        self.model = nn.ModuleList(layers)
        self.stem_widths = tuple(ch[:2])
        self._stem_foldable = self._spec_folds_stem()

    def _spec_folds_stem(self) -> bool:
        """The JAX model's spec gate (yolo.py:398-410): layers 0 and 1 are
        Conv(., 3, 2) and no later layer reads layer 0 or 1."""
        if len(self.spec) < 3:
            return False
        if any(mod != "Conv" or list(args[1:]) != [3, 2] for _, _, mod, args in self.spec[:2]):
            return False
        for frm, _, _, _ in self.spec[2:]:
            refs = frm if isinstance(frm, (list, tuple)) else [frm]
            if any(r in (0, 1) for r in refs):
                return False
        return True

    @property
    def stem_route(self) -> str:
        """"fused" (ops/stem.py:fused_stem, K4 on the card) or "conv" (the
        two Conv modules), decided from the spec alone, as the JAX model's
        gate (yolo.py:398-410), so the CPU and the card take the same route:
        every scale folds its stem but yolov9e, whose later layers read
        layer 0."""
        return "fused" if self.folded_stem and self._stem_foldable else "conv"

    def _can_fold_stem(self, x: torch.Tensor) -> bool:
        """Inference only, on the fused route, H and W multiples of 4."""
        return (not self.training and self.stem_route == "fused"
                and x.shape[2] % 4 == 0 and x.shape[3] % 4 == 0)

    def forward(self, x: torch.Tensor):
        x = x.to(self.compute_dtype)  # after normalisation, as yolo.py:416
        ys: List = []
        start = 0
        # an sp shard (parallel/spatial.py) may hold ``overlap`` image rows
        # above its own: the fused stem (K4 on the slab) reads them and its
        # first output row, spoiled by the kernel's zero padding, is dropped;
        # the Conv route drops them and exchanges halos instead
        shard = spatial.current()
        overlap = shard.overlap if shard is not None else 0
        if self._can_fold_stem(x):
            x = fused_stem(x, self.model[0], self.model[1], self.compute_dtype)
            if overlap:
                x = x[:, :, overlap // 4:]
            ys.extend([x, x])  # ys[0] is never read (checked by _spec_folds_stem)
            start = 2
        elif overlap:
            x = x[:, :, overlap:]
        remat = self.remat and self.training and torch.is_grad_enabled()

        def run(m, inp):
            if remat:  # a recompute (a card's autograd thread) runs under this shard too
                return checkpoint(m, inp, use_reentrant=False,
                                  context_fn=spatial.checkpoint_contexts)
            return m(inp)

        for li, ((frm, _, mod, _), m) in enumerate(zip(self.spec, self.model)):
            if li < start:
                continue
            if mod == "Detect":
                neck = [ys[i] for i in frm]
                out = run(m, neck)
                if isinstance(shard, spatial.RankShard):  # the loss reads whole maps
                    out = tuple(map(shard.gather_outputs, out)) if isinstance(out, tuple) \
                        else shard.gather_outputs(out)
                if isinstance(out, tuple):  # one2one first (yolo.py:436-452)
                    return out[1], neck, out[0]
                return out, neck
            if isinstance(frm, int):
                x = run(m, x if frm == -1 else ys[frm])
            else:
                x = run(m, [x if i == -1 else ys[i] for i in frm])
            ys.append(x)
        raise RuntimeError("spec did not terminate with a Detect layer")


def build_model(name: str, nc: int = 80, dtype: torch.dtype = torch.float32,
                folded_stem: bool = True) -> YOLODetector:
    """A detector by name, computing in ``dtype``: every name of the JAX
    package's SCALES ('yolov8n' .. 'yolov8x', 'yolov9t/s/m/c/e',
    'yolov10n/s/m/b/l/x', 'yolo11n' .. 'yolo11x', 'yolo12n' .. 'yolo12x')."""
    for family in sorted(SPECS, key=len, reverse=True):
        if name.startswith(family):
            size = name[len(family):]
            if size not in SCALES[family]:
                raise ValueError(f"unknown size '{size}' for {family}; have {list(SCALES[family])}")
            depth, width, max_ch = SCALES[family][size]
            style = HEAD_STYLE[family]
            return YOLODetector(
                SPECS[family], nc=nc, depth=depth, width=width, max_channels=max_ch,
                head_style="v11" if style == "v12" else style,
                attn_residual=family == "yolo12" and size in ("l", "x"),
                c3k_force=family in ("yolo11", "yolo12") and size in ("m", "l", "x"),
                folded_stem=folded_stem, dtype=dtype)
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
