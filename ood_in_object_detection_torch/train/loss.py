"""YOLOv8-family detection loss (port of ood_in_object_detection_tpu/train/loss.py).

Semantics of the reference v8DetectionLoss (ultralytics/utils/loss.py): BCE
classification on TAL soft targets, CIoU box loss and Distribution Focal
Loss on assigned anchors, gains box 7.5 / cls 0.5 / dfl 1.5
(cfg/default.yaml), on fixed-shape padded ground truth. The raw maps come
in NCHW, (B, 4*REG_MAX + nc, H, W) per level, and are flattened to the
JAX package's anchor order: level by level, then y, then x
(models/head.py:make_anchors).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..models.head import REG_MAX, make_anchors
from ..parallel.distributed import all_reduce_sum, loss_axis
from .tal import assign, ciou  # noqa: F401 — ciou re-exported, as the JAX module does


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution Focal Loss (reference utils/loss.py BboxLoss._df_loss):
    cross-entropy against the two integer bins bracketing the target,
    linearly weighted. pred_dist (..., 4, REG_MAX) logits, target (..., 4)."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ce_l = -logp.gather(-1, tl.clamp(0, REG_MAX - 1)[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, REG_MAX - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def flatten_levels(raw_levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """3 x (B, C, H, W) -> (B, A, C) in f32, anchors level-major, then y,
    then x (the JAX package's NHWC reshape)."""
    return torch.cat([f.flatten(2) for f in raw_levels], dim=2).transpose(1, 2).float()


def detection_loss(raw_levels: Sequence[torch.Tensor],  # 3 x (B, 4*REG_MAX+nc, H, W)
                   gt_labels: torch.Tensor,             # (B, M) integer
                   gt_bboxes_xyxy: torch.Tensor,        # (B, M, 4) input-image pixels
                   gt_mask: torch.Tensor,               # (B, M) bool
                   nc: int, box_gain: float = 7.5, cls_gain: float = 0.5,
                   dfl_gain: float = 1.5, assign_topk: int = 10) -> LossBreakdown:
    """Total loss times the batch size, as the reference trainer's
    (utils/loss.py v8DetectionLoss.__call__ returns loss.sum() * batch_size).

    Inside ``parallel.distributed.global_batch`` on more than one batch
    shard the normalizer (the target scores' sum) and the batch size are
    the global batch's (summed over its loss axis, one rank a batch shard),
    so each rank returns its batch shard's share of the JAX package's one
    global loss: the shares, and their gradients, sum over the batch shards
    to the global loss and its gradient. (On an ``sp`` axis every rank of a
    batch shard computes its share from the gathered maps; each one's
    gradient flows back through its own rows, models/yolo.py.)"""
    B = raw_levels[0].shape[0]
    axis = loss_axis()
    dev = raw_levels[0].device
    anchors, strides = make_anchors([(f.shape[2], f.shape[3]) for f in raw_levels], device=dev)
    x = flatten_levels(raw_levels)                                # (B, A, 64 + nc)
    pred_dist = x[..., :4 * REG_MAX].reshape(B, -1, 4, REG_MAX)
    pred_logits = x[..., 4 * REG_MAX:]

    # boxes decoded in grid units for the assignment (loss.py bbox_decode)
    dist = torch.softmax(pred_dist, dim=-1) @ torch.arange(REG_MAX, dtype=torch.float32,
                                                            device=dev)
    pd_bboxes = torch.cat([anchors[None] - dist[..., :2], anchors[None] + dist[..., 2:]], -1)

    # the assignment in image pixels, without gradient: the reference
    # assigner runs under torch.no_grad() (utils/tal.py:40), the JAX one
    # under stop_gradient (loss.py:93-98)
    with torch.no_grad():
        res = assign(torch.sigmoid(pred_logits), pd_bboxes * strides[None, :, None],
                     anchors * strides[:, None], gt_labels.long().clamp(0, nc - 1),
                     gt_bboxes_xyxy.float(), gt_mask, topk=assign_topk)

    target_scores_sum = res.target_scores.sum()
    global_b = B
    if axis is not None:
        all_reduce_sum([target_scores_sum], axis.group)
        global_b = B * axis.size
    target_scores_sum = target_scores_sum.clamp(min=1.0)
    cls_loss = bce_with_logits(pred_logits, res.target_scores).sum() / target_scores_sum

    # box and DFL terms on the foreground anchors
    fg = res.fg_mask
    weight = res.target_scores.sum(-1)                            # (B, A)
    tboxes = res.target_bboxes / strides[None, :, None]
    zero = torch.zeros((), device=dev)
    iou_term = 1.0 - ciou(pd_bboxes, tboxes)
    box_loss = torch.where(fg, iou_term * weight, zero).sum() / target_scores_sum

    tdist = torch.cat([anchors[None] - tboxes[..., :2], tboxes[..., 2:] - anchors[None]], -1)
    tdist = tdist.clamp(0, REG_MAX - 1 - 0.01)
    dfl_loss = torch.where(fg, df_loss(pred_dist, tdist) * weight, zero).sum() / target_scores_sum

    total = (box_gain * box_loss + cls_gain * cls_loss + dfl_gain * dfl_loss) * global_b
    return LossBreakdown(total, box_loss, cls_loss, dfl_loss)


def v10_detection_loss(raw_one2many: Sequence[torch.Tensor],
                       raw_one2one: Sequence[torch.Tensor],
                       gt_labels: torch.Tensor, gt_bboxes_xyxy: torch.Tensor,
                       gt_mask: torch.Tensor, nc: int, **gains) -> LossBreakdown:
    """v10 end2end dual loss (reference utils/loss.py E2EDetectLoss): the
    one2many TAL loss (top 10) plus the one2one loss with one-to-one
    assignment (top 1). The one2one branch runs on detached features
    (models/head.py:Detect.forward in training). On a mesh each of the two
    takes its normalizer and batch size over the global batch."""
    lm = detection_loss(raw_one2many, gt_labels, gt_bboxes_xyxy, gt_mask, nc,
                        assign_topk=10, **gains)
    lo = detection_loss(raw_one2one, gt_labels, gt_bboxes_xyxy, gt_mask, nc,
                        assign_topk=1, **gains)
    return LossBreakdown(lm.total + lo.total, lm.box + lo.box, lm.cls + lo.cls, lm.dfl + lo.dfl)
