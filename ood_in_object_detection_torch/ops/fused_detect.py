"""Lazy detect: DFL decode per level, confidence top-k, NMS, logits gather.

Port of ood_in_object_detection_tpu/ops/fused_detect.py. Boxes are decoded
per level from the raw (B, 4*REG_MAX+nc, H, W) maps with the DFL softmax
taken per 16-bin chunk (max subtracted per chunk, reference DFL conv
nn/modules/block.py:56-75); confidence is sigmoid(max logit) and the class
its argmax. Only the pre-NMS candidates go through NMS, and each kept box's
pre-sigmoid logits are gathered after NMS (the OoD tap).

bf16 raw maps (--bf16) are upcast where the JAX package upcasts them: the
box bins before the DFL softmax (fused_detect.py:65), the class logits
before their max (:111; the argmax stays on the bf16 logits, as there) and
the gathered logits (:139). Everything downstream of the maps is f32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.head import REG_MAX, STRIDES
from .nms import Detections, suppress_and_select, topk_stable


def dfl_boxes(f: torch.Tensor, stride: float) -> torch.Tensor:
    """(B, 4*REG_MAX+nc, H, W) raw map -> (B, H*W, 4) xyxy pixels."""
    b, _, h, w = f.shape
    x = f[:, : 4 * REG_MAX].float().reshape(b, 4, REG_MAX, h, w)
    e = torch.exp(x - x.amax(dim=2, keepdim=True))
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=f.device).view(1, 1, REG_MAX, 1, 1)
    dist = (e * bins).sum(dim=2) / e.sum(dim=2)          # (B, 4, H, W) ltrb grid units
    gx = torch.arange(w, dtype=torch.float32, device=f.device) + 0.5
    gy = (torch.arange(h, dtype=torch.float32, device=f.device) + 0.5)[:, None]
    boxes = torch.stack([(gx - dist[:, 0]) * stride, (gy - dist[:, 1]) * stride,
                         (gx + dist[:, 2]) * stride, (gy + dist[:, 3]) * stride], dim=-1)
    return boxes.reshape(b, h * w, 4)


class Candidates(NamedTuple):
    """The pre-NMS top-k of one batch, in descending confidence order."""

    boxes: torch.Tensor   # (B, k, 4) xyxy
    conf: torch.Tensor    # (B, k), -1 where not above conf_thres
    cls: torch.Tensor     # (B, k)
    idx: torch.Tensor     # (B, k) flat anchor index
    logits: torch.Tensor  # (B, A, nc) pre-sigmoid logits of every anchor


def select_candidates(raw_levels: Sequence[torch.Tensor], nc: int, conf_thres,
                      pre_nms_k: int) -> Candidates:
    """Decode and keep the ``pre_nms_k`` most confident anchors; ties keep
    the lower anchor index first (lax.top_k's order)."""
    b = raw_levels[0].shape[0]
    if raw_levels[0].shape[1] != 4 * REG_MAX + nc:
        raise ValueError(f"raw maps have {raw_levels[0].shape[1]} channels, "
                         f"expected 4*{REG_MAX}+{nc}")
    confs, clss, boxes, logits = [], [], [], []
    for f, s in zip(raw_levels, STRIDES):
        cl = f[:, 4 * REG_MAX:].flatten(2)                   # (B, nc, HW)
        confs.append(cl.float().amax(dim=1))
        clss.append(cl.argmax(dim=1))
        boxes.append(dfl_boxes(f, s))
        logits.append(cl.transpose(1, 2))
    conf_all = torch.sigmoid(torch.cat(confs, dim=1))           # (B, A)
    cls_all = torch.cat(clss, dim=1)
    box_all = torch.cat(boxes, dim=1)
    log_all = torch.cat(logits, dim=1)                          # (B, A, nc)
    k = min(pre_nms_k, conf_all.shape[1])
    ct = torch.as_tensor(conf_thres, dtype=torch.float32, device=conf_all.device)
    masked = torch.where(conf_all > ct, conf_all, torch.full_like(conf_all, -1.0))
    top_conf, top_idx = topk_stable(masked, k)
    top_boxes = torch.gather(box_all, 1, top_idx[..., None].expand(b, k, 4))
    top_cls = torch.gather(cls_all, 1, top_idx)
    return Candidates(top_boxes, top_conf, top_cls, top_idx, log_all)


class FusedDetections(NamedTuple):
    det: Detections
    logits: torch.Tensor  # (B, max_det, nc) pre-sigmoid logits per box, 0 if invalid


def fused_detect(
    raw_levels: Sequence[torch.Tensor],
    nc: int,
    conf_thres,
    iou_thres: float = 0.7,  # ultralytics predict default (cfg/default.yaml:57)
    max_det: int = 300,
    pre_nms_k: int = 512,
    class_agnostic: bool = False,
) -> FusedDetections:
    """Detect + NMS straight from the raw head maps.

    ``conf_thres`` may be a float or a 0-dim tensor; a threshold sweep
    changes no shape."""
    c = select_candidates(raw_levels, nc, conf_thres, pre_nms_k)
    det, _ = suppress_and_select(c.boxes, c.conf, c.cls, c.idx, conf_thres,
                                 iou_thres, max_det, class_agnostic)
    det_logits = torch.gather(c.logits, 1, det.anchor_idx[..., None].expand(-1, -1, nc))
    det_logits = det_logits.float() * det.valid[..., None]
    return FusedDetections(det, det_logits)
