"""Plain decode, greedy NMS, RoIAlign and exact-position taps.

Written from ultralytics' ``utils/ops.py`` (DFL decode, class-offset NMS
on the best class) and torchvision's ``roi_align`` (1x1 output,
``aligned=False``, adaptive sampling, ``spatial_scale`` = map width /
image width, as ultralytics' OoD predictor calls it; samples more than a
cell outside the map clamp onto its edge, as the program states it, where
torchvision drops them), with the program's stated selection: the ``pre_nms_k`` most confident anchors above
``conf_thres`` go to NMS (ties: lower anchor first), ``max_det`` are kept.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import precision as P
from .model import REG_MAX

STRIDES = (8, 16, 32)
MAX_WH = 7680.0


class Anchors(NamedTuple):
    """Per anchor of a batch, flat over the levels (P3 first, x fastest)."""

    boxes: torch.Tensor   # (B, A, 4) xyxy pixels, unclipped
    conf: torch.Tensor    # (B, A) sigmoid of the best class logit
    cls: torch.Tensor     # (B, A) best class
    logits: torch.Tensor  # (B, A, nc)
    level: torch.Tensor   # (A,) 0, 1, 2
    local: torch.Tensor   # (A,) cell index within its level


def decode(raw: Sequence[torch.Tensor], nc: int) -> Anchors:
    boxes, logits, levels, local = [], [], [], []
    for li, (f, s) in enumerate(zip(raw, STRIDES)):
        f = P.operand(f.float())
        b, _, h, w = f.shape
        d = f[:, :4 * REG_MAX].reshape(b, 4, REG_MAX, h * w).softmax(2)
        dist = (d * torch.arange(REG_MAX, device=f.device, dtype=torch.float32)[:, None]).sum(2)
        gy, gx = torch.meshgrid(torch.arange(h, device=f.device, dtype=torch.float32) + 0.5,
                                torch.arange(w, device=f.device, dtype=torch.float32) + 0.5,
                                indexing="ij")
        gx, gy = gx.reshape(-1), gy.reshape(-1)
        boxes.append(torch.stack([gx - dist[:, 0], gy - dist[:, 1],
                                  gx + dist[:, 2], gy + dist[:, 3]], -1) * s)
        logits.append(f[:, 4 * REG_MAX:].reshape(b, nc, h * w).transpose(1, 2))
        levels.append(torch.full((h * w,), li, device=f.device))
        local.append(torch.arange(h * w, device=f.device))
    lg = torch.cat(logits, 1)
    best, cls = lg.max(-1)
    return Anchors(torch.cat(boxes, 1), torch.sigmoid(best), cls, lg, torch.cat(levels),
                   torch.cat(local))


def iou_matrix(a: np.ndarray) -> np.ndarray:
    area = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], a[None, :, :2])
    rb = np.minimum(a[:, None, 2:], a[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area[:, None] + area[None, :] - inter + 1e-7)


def nms_image(boxes: np.ndarray, conf: np.ndarray, cls: np.ndarray, conf_thres: float,
              iou_thres: float, max_det: int, pre_nms_k: int) -> np.ndarray:
    """Kept anchor indices of one image, most confident first."""
    cand = np.flatnonzero(conf > conf_thres)
    order = cand[np.argsort(-conf[cand], kind="stable")][:pre_nms_k]
    if len(order) == 0:
        return order
    shifted = boxes[order].astype(np.float64) + cls[order, None].astype(np.float64) * MAX_WH
    over = iou_matrix(shifted) > iou_thres
    alive = np.ones(len(order), bool)
    for i in range(len(order)):
        if alive[i]:
            alive[i + 1:] &= ~over[i, i + 1:]
    return order[alive][:max_det]


def nms(anchors: Anchors, conf_thres: float, iou_thres: float, max_det: int,
        pre_nms_k: int) -> List[np.ndarray]:
    boxes = anchors.boxes.cpu().numpy()
    conf = anchors.conf.cpu().numpy()
    cls = anchors.cls.cpu().numpy()
    return [nms_image(boxes[i], conf[i], cls[i], conf_thres, iou_thres, max_det, pre_nms_k)
            for i in range(len(boxes))]


def _axis_taps(lo: torch.Tensor, length: torch.Tensor, size: int,
               outside: str = "border") -> torch.Tensor:
    """Bilinear sample weights along one axis, averaged over the adaptive
    grid of ceil(length) samples -> (N, size). A sample within one cell of
    the map clamps onto its edge, as in torchvision. One farther out
    clamps onto the edge too with ``outside="border"``, the program's
    stated rule (ops/roi_align.py: "samples outside [0, size-1] clamped to
    the border cells", as the JAX package states it); torchvision drops it
    (``outside="zero"``)."""
    n = torch.ceil(length).clamp(min=1)
    smax = int(n.max().item())
    s = torch.arange(smax, device=lo.device, dtype=torch.float32)
    u = lo[:, None] + (s[None] + 0.5) * (length / n)[:, None]        # (N, S)
    used = s[None] < n[:, None]
    inside = (u >= -1.0) & (u <= size) if outside == "zero" else torch.ones_like(used)
    u = u.clamp(min=0.0)
    low = torch.floor(u)
    top = low >= size - 1
    low = torch.where(top, torch.full_like(low, size - 1), low)
    u = torch.where(top, low, u)
    frac = u - low
    high = torch.clamp(low + 1, max=size - 1)
    keep = (used & inside).float()
    w = torch.zeros(lo.shape[0], size, device=lo.device)
    w.scatter_add_(1, low.long(), (1 - frac) * keep)
    w.scatter_add_(1, high.long(), frac * keep)
    return w / n[:, None]


def roi_align_1x1(fmap: torch.Tensor, boxes: torch.Tensor, img_w: int,
                  outside: str = "border") -> torch.Tensor:
    """(H, W, C) map, (N, 4) xyxy image pixels -> (N, C) f32."""
    h, w, _ = fmap.shape
    scale = w / img_w
    b = boxes.float() * scale
    wx = _axis_taps(b[:, 0], torch.clamp(b[:, 2] - b[:, 0], min=1.0), w, outside)
    wy = _axis_taps(b[:, 1], torch.clamp(b[:, 3] - b[:, 1], min=1.0), h, outside)
    rows = torch.einsum("nh,hwc->nwc", P.operand(wy), P.operand(fmap.float()))
    return torch.einsum("nw,nwc->nc", P.operand(wx), P.operand(rows))


def taps(neck: Sequence[torch.Tensor], image: int, boxes: torch.Tensor, level: torch.Tensor,
         local: torch.Tensor, img_w: int, outside: str = "border"):
    """RoI and exact-position features of one image's boxes, each at its
    anchor's level: two lists of (C_level,) f32 numpy arrays."""
    roi, exact = [None] * len(boxes), [None] * len(boxes)
    for li, f in enumerate(neck):
        idx = torch.nonzero(level == li).flatten()
        if len(idx) == 0:
            continue
        fm = f[image].permute(1, 2, 0)  # (H, W, C)
        r = roi_align_1x1(fm, boxes[idx], img_w, outside).cpu().numpy()
        e = P.operand(fm.reshape(-1, fm.shape[-1])[local[idx]].float()).cpu().numpy()
        for k, j in enumerate(idx.tolist()):
            roi[j], exact[j] = r[k], e[k]
    return roi, exact
