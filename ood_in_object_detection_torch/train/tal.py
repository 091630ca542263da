"""Task-Aligned Assigner (port of ood_in_object_detection_tpu/train/tal.py).

Semantics of the reference TaskAlignedAssigner (ultralytics/utils/tal.py:
14-230), as the JAX package computes them on padded ground truth: align
metric = score^alpha * CIoU^beta (CIoU clamped at 0), candidates restricted
to anchors strictly inside the gt box, the top-k (10) candidates per gt,
an anchor claimed by several gts kept by the one of largest CIoU, soft
targets normalised per gt by (max CIoU / max metric).

The JAX package picks the top k by k rounds of argmax and mask-out
(tal.py:103-116): first index first over ties, zero-metric anchors picked
too (``& valid`` drops them after). ``torch.topk`` promises no order among
ties, so the rounds stay; ``torch.argmax`` returns the first maximal index
on the CPU and on CUDA. Its one-hot lookups are gathers here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between box pairs (..., 4) xyxy, broadcasting
    (reference utils/metrics.py bbox_iou CIoU=True; a=box1, b=box2); the
    aspect term's weight alpha carries no gradient (tal.py:43)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    aw, ah = ax2 - ax1, ay2 - ay1
    bw, bh = bx2 - bx1, by2 - by1
    inter = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0) * \
        (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    union = aw * ah + bw * bh - inter + eps
    iou = inter / union
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    ch = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((bx1 + bx2 - ax1 - ax2) ** 2 + (by1 + by2 - ay1 - ay2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(bw / (bh + eps)) - torch.atan(aw / (ah + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


class AssignResult(NamedTuple):
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy, the gt boxes' units
    target_scores: torch.Tensor  # (B, A, nc) soft targets
    fg_mask: torch.Tensor        # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def iou_xyxy(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / (union + eps)


def assign(pd_scores: torch.Tensor,   # (B, A, nc) post-sigmoid
           pd_bboxes: torch.Tensor,   # (B, A, 4) xyxy
           anc_points: torch.Tensor,  # (A, 2)
           gt_labels: torch.Tensor,   # (B, M) integer
           gt_bboxes: torch.Tensor,   # (B, M, 4) xyxy
           gt_mask: torch.Tensor,     # (B, M) bool
           topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
           eps: float = 1e-9) -> AssignResult:
    """Targets for every anchor (tal.py:58-148 of the JAX package)."""
    B, A, nc = pd_scores.shape
    M = gt_labels.shape[1]
    topk = min(topk, A)
    gt_mask = gt_mask.bool()

    # candidates: anchor centre strictly inside the gt box
    lt_ok = anc_points[None, None] - gt_bboxes[:, :, None, :2]          # (B, M, A, 2)
    rb_ok = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    in_gts = torch.cat([lt_ok, rb_ok], -1).amin(-1) > eps                # (B, M, A)

    # alignment metric on the CIoU clamped at 0 (reference iou_calculation)
    gt_lab = gt_labels.long().clamp(0, nc - 1)
    scores_for_gt = pd_scores.transpose(1, 2).gather(
        1, gt_lab[:, :, None].expand(B, M, A))                           # (B, M, A)
    ious = ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]).clamp(min=0.0)
    align = scores_for_gt ** alpha * ious ** beta                        # (B, M, A)

    valid = in_gts & gt_mask[:, :, None]
    x = torch.where(valid, align, torch.zeros_like(align))

    # top-k per gt: k rounds of argmax and mask-out, first index over ties
    mask_topk = torch.zeros((B, M, A), dtype=torch.bool, device=x.device)
    for _ in range(topk):
        oh = torch.zeros_like(mask_topk).scatter_(-1, x.argmax(-1, keepdim=True), True)
        mask_topk |= oh & gt_mask[:, :, None]
        x = x.masked_fill(oh, -1.0)
    mask_pos = mask_topk & valid                                         # (B, M, A)

    # an anchor claimed by more than one gt keeps the one of largest CIoU
    claimed = mask_pos.sum(1)                                            # (B, A)
    best_gt = torch.where(mask_pos, ious, torch.full_like(ious, -1.0)).argmax(1)
    onehot_best = torch.zeros_like(mask_pos).scatter_(1, best_gt[:, None], True)
    mask_pos = torch.where((claimed > 1)[:, None, :], mask_pos & onehot_best, mask_pos)

    fg_mask = mask_pos.any(1)                                            # (B, A)
    target_gt_idx = mask_pos.to(torch.uint8).argmax(1)                   # (B, A)

    tb = gt_bboxes.gather(1, target_gt_idx[..., None].expand(B, A, 4))  # (B, A, 4)
    tl = gt_lab.gather(1, target_gt_idx)                                 # (B, A)

    # normalised soft targets (reference tal.py:150-176)
    align_pos = torch.where(mask_pos, align, torch.zeros_like(align))
    iou_pos = torch.where(mask_pos, ious, torch.zeros_like(ious))
    pos_align_max = align_pos.amax(-1, keepdim=True)                     # (B, M, 1)
    pos_iou_max = iou_pos.amax(-1, keepdim=True)
    anchor_score = (align_pos * pos_iou_max / (pos_align_max + eps)).amax(1)  # (B, A)

    t_scores = torch.nn.functional.one_hot(tl, nc).to(anchor_score.dtype) * anchor_score[..., None]
    t_scores = torch.where(fg_mask[..., None], t_scores, torch.zeros_like(t_scores))
    return AssignResult(tb, t_scores, fg_mask, target_gt_idx)
