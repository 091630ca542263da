"""YOLO Detect head (port of ood_in_object_detection_tpu/models/head.py).

The head returns the raw per-level maps (B, 4*REG_MAX + nc, H, W) with
pre-sigmoid class logits; decoding happens lazily in ops/fused_detect.py.
:func:`decode_detections` is the full-anchor decode, kept as the test
oracle of that lazy path.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import Conv, conv_in_dtype

REG_MAX = 16
STRIDES = (8, 16, 32)


class DFL(nn.Module):
    """Holds the reference's frozen DFL conv (weights arange(REG_MAX)) so
    that ultralytics-named state_dicts load; the decode does not call it."""

    def __init__(self, c1: int = REG_MAX):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1))


class Detect(nn.Module):
    """Decoupled head: box branch cv2 (Conv3-Conv3-Conv1 to 4*REG_MAX) and
    class branch cv3 to nc per level. ``style`` picks the class branch
    (head.py:34-91 of the JAX package): "v8" Conv3-Conv3-Conv1; "v11" and
    "v10" (DWConv3 + Conv1) x 2 + Conv1, the depthwise convs grouped by
    their input channels. The v10 head is dual: it also holds the
    one2one_cv2/cv3 copies, so that the reference checkpoint's keys load.
    Its eval forward runs only the one2one branches (the inference path,
    as the JAX predict step keeps only them); in training it returns
    (one2many maps, one2one maps)."""

    def __init__(self, nc: int, ch: Sequence[int], style: str = "v8"):
        super().__init__()
        if style not in ("v8", "v10", "v11"):
            raise ValueError(f"unknown head style {style}")
        self.nc = nc
        self.dual = style == "v10"
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))

        def box(x):
            return nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))

        def cls(x):
            if style == "v8":
                return nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1))
            return nn.Sequential(nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
                                 nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
                                 nn.Conv2d(c3, nc, 1))

        self.cv2 = nn.ModuleList(box(x) for x in ch)
        self.cv3 = nn.ModuleList(cls(x) for x in ch)
        if self.dual:
            self.one2one_cv2 = nn.ModuleList(box(x) for x in ch)
            self.one2one_cv3 = nn.ModuleList(cls(x) for x in ch)
        self.dfl = DFL(REG_MAX)

    def _pairs(self):
        """(box, class) branches: cv2/cv3, then the v10 head's one2one copies."""
        pairs = [(self.cv2, self.cv3)]
        if self.dual:
            pairs.append((self.one2one_cv2, self.one2one_cv3))
        return pairs

    def bias_init(self) -> None:
        """Box bias 1.0, class bias log(5 / nc / (640 / s)^2), on every
        branch (reference Detect.bias_init; the JAX package's Conv2dRaw
        bias inits)."""
        with torch.no_grad():
            for boxes, clss in self._pairs():
                for box, cls, s in zip(boxes, clss, STRIDES):
                    box[-1].bias.fill_(1.0)
                    cls[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, feats: Sequence[torch.Tensor]):
        """Raw maps in the neck's dtype (head.py:48-89 with dtype): the
        dual head's one2one maps alone in eval, both in training, the
        one2one pair then on detached features (head.py:55), so that its
        loss trains that pair alone."""
        def branch(seq, x):
            return conv_in_dtype(seq[2], seq[1](seq[0](x)))

        def maps(boxes, clss, xs):
            return [torch.cat([branch(box, x), branch(cls, x)], dim=1)
                    for x, box, cls in zip(xs, boxes, clss)]

        if not self.dual:
            return maps(self.cv2, self.cv3, feats)
        if not self.training:  # one2one alone: the inference path
            return maps(self.one2one_cv2, self.one2one_cv3, feats)
        return (maps(self.cv2, self.cv3, feats),
                maps(self.one2one_cv2, self.one2one_cv3, [f.detach() for f in feats]))


def make_anchors(hw_per_level: Sequence[Tuple[int, int]], strides=STRIDES,
                 offset: float = 0.5, device=None):
    """Anchor centres (A, 2) in grid units (x fastest) and per-anchor stride."""
    pts, sts = [], []
    for (h, w), s in zip(hw_per_level, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        sts.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(sts)


def decode_detections(raw_levels: Sequence[torch.Tensor], nc: int):
    """Full-anchor decode of raw (B, 4*REG_MAX+nc, H, W) maps ->
    boxes_xywh (B, A, 4) pixels, cls_logits (B, A, nc), anchor_strides (A,)."""
    hw = [(f.shape[2], f.shape[3]) for f in raw_levels]
    anchors, strides = make_anchors(hw, device=raw_levels[0].device)
    x = torch.cat([f.flatten(2) for f in raw_levels], dim=2).transpose(1, 2)
    b, a, _ = x.shape
    probs = torch.softmax(x[..., : 4 * REG_MAX].float().reshape(b, a, 4, REG_MAX), dim=-1)
    dist = probs @ torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
    x1y1 = anchors[None] - dist[..., :2]
    x2y2 = anchors[None] + dist[..., 2:]
    boxes = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1) * strides[None, :, None]
    return boxes, x[..., 4 * REG_MAX:], strides
