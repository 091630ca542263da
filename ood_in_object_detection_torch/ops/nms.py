"""Fixed-shape batched NMS returning anchor indices, and kernel K1's wrapper.

Port of ood_in_object_detection_tpu/ops/nms.py. Semantics (reference
ultralytics/utils/ops.py:348-533, best-class-only path): candidates are
boxes whose max-class sigmoid score exceeds ``conf_thres``; per-class NMS by
offsetting boxes by ``cls * MAX_WH``; greedy IoU suppression in descending
confidence order; the top ``max_det`` survivors are returned as padded
``Detections`` with a ``valid`` mask and each box's flat anchor index.

The keep mask comes from :func:`greedy_keep`, which calls the operator
``ood_torch::nms_keep`` (ops/library.py): it launches CUDA kernel K1
(``csrc/nms_keep.cu``) for every candidate count on a CUDA tensor, and runs
its plain PyTorch version :func:`greedy_keep_plain` on a CPU tensor. Any
``pre_nms_k`` is served, as the JAX package's ``_greedy_keep_tiled`` serves
it.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import torch

from . import library
from .boxes import box_iou, xywh2xyxy

MAX_WH = 7680.0


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, lower index first on ties
    (lax.top_k's order; bare torch.topk does not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                      iou_thres: float) -> torch.Tensor:
    """Plain PyTorch greedy-NMS keep mask: (B, k, 4) score-sorted boxes and
    (B, k) validity -> (B, k) bool.

    Iterates ``alive = valid & ~any(sup & alive[:, None])`` over the full
    upper-triangular suppression matrix to its fixpoint, which is the greedy
    solution (suppression is a DAG in score order; the same iteration as the
    Pallas kernel, ops/pallas/nms.py:_keep_kernel)."""
    k = boxes.shape[-2]
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (box_iou(boxes, boxes) > thr) & upper                     # (B, k, k)
    alive = valid.clone()
    for _ in range(k):
        new = valid & ~(sup & alive[..., :, None]).any(dim=-2)
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask, (B, k, 4) f32 score-sorted class-offset boxes +
    (B, k) bool validity -> (B, k) bool.

    Replaces ops/pallas/nms.py:greedy_keep_pallas. Calls the operator
    ``ood_torch::nms_keep`` (ops/library.py): CUDA tensors launch kernel K1
    (csrc/nms_keep.cu) for every k and count the launch in ``launches``
    (and per card index in ``launches_by_device``); CPU tensors take :func:`greedy_keep_plain`."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"greedy_keep: boxes {tuple(boxes.shape)} and valid "
                         f"{tuple(valid.shape)} must be (B, k, 4) and (B, k)")
    return library.nms_keep_op(boxes, valid, float(iou_thres))


greedy_keep.launches = 0
greedy_keep.launches_by_device = collections.Counter()


class Detections(NamedTuple):
    """Padded per-image detections (leading batch dim on every field)."""

    boxes: torch.Tensor       # (B, max_det, 4) xyxy pixels
    conf: torch.Tensor        # (B, max_det)
    cls: torch.Tensor         # (B, max_det) int64
    anchor_idx: torch.Tensor  # (B, max_det) int64, index into the A anchors
    valid: torch.Tensor       # (B, max_det) bool

    @property
    def num_valid(self):
        return self.valid.sum(dim=-1)


def nms_inputs(top_boxes, top_conf, top_cls, conf_thres, class_agnostic: bool = False):
    """(class-offset boxes, validity) that suppress_and_select hands to
    greedy_keep: per-class NMS by shifting boxes by ``cls * MAX_WH``."""
    top_valid = top_conf > conf_thres
    if class_agnostic:
        return top_boxes.contiguous(), top_valid
    offset = top_cls.to(torch.float32) * MAX_WH
    return (top_boxes + offset[..., None]).contiguous(), top_valid


def suppress_and_select(
    top_boxes: torch.Tensor,  # (B, k, 4) xyxy, descending-confidence order
    top_conf: torch.Tensor,   # (B, k)
    top_cls: torch.Tensor,    # (B, k) int
    top_idx: torch.Tensor,    # (B, k) flat anchor indices
    conf_thres,
    iou_thres: float,
    max_det: int,
    class_agnostic: bool = False,
) -> Tuple[Detections, torch.Tensor]:
    """Greedy suppression over pre-selected candidates + final top-max_det.

    Returns the Detections plus ``sel``, each detection's index into the k
    candidates (0 where invalid)."""
    k = top_boxes.shape[1]
    conf_thres = torch.as_tensor(conf_thres, dtype=torch.float32, device=top_conf.device)
    shifted, top_valid = nms_inputs(top_boxes, top_conf, top_cls, conf_thres, class_agnostic)
    keep = greedy_keep(shifted, top_valid, iou_thres)

    final_conf = torch.where(keep, top_conf, torch.full_like(top_conf, -1.0))
    md = min(max_det, k)
    sel_conf, sel = topk_stable(final_conf, md)
    valid = sel_conf > conf_thres
    boxes_sel = torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4))
    cls_sel = torch.gather(top_cls, 1, sel)
    idx_sel = torch.gather(top_idx, 1, sel)
    pad = max_det - md

    def p(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3 else (0, pad))

    zero = torch.zeros((), dtype=cls_sel.dtype, device=cls_sel.device)
    det = Detections(
        boxes=p(boxes_sel * valid[..., None].to(boxes_sel.dtype)),
        conf=p(torch.where(valid, sel_conf, torch.zeros_like(sel_conf))),
        cls=p(torch.where(valid, cls_sel, zero)),
        anchor_idx=p(torch.where(valid, idx_sel, zero)),
        valid=p(valid),
    )
    return det, p(torch.where(valid, sel, torch.zeros_like(sel)))


def batched_nms(
    boxes_xywh: torch.Tensor,   # (B, A, 4) decoded cxcywh pixels
    cls_logits: torch.Tensor,   # (B, A, nc) pre-sigmoid
    conf_thres=0.25,
    iou_thres: float = 0.7,  # ultralytics predict default (cfg/default.yaml:57)
    max_det: int = 300,
    pre_nms_k: int = 2048,
    class_agnostic: bool = False,
) -> Detections:
    """Full-anchor NMS (the test oracle of the lazy fused_detect path)."""
    k = min(pre_nms_k, boxes_xywh.shape[1])
    scores = torch.sigmoid(cls_logits.float())
    conf = scores.amax(dim=-1)
    cls = scores.argmax(dim=-1)
    ct = torch.as_tensor(conf_thres, dtype=torch.float32, device=conf.device)
    masked = torch.where(conf > ct, conf, torch.full_like(conf, -1.0))
    top_conf, top_idx = topk_stable(masked, k)
    top_boxes = xywh2xyxy(torch.gather(boxes_xywh, 1, top_idx[..., None].expand(-1, -1, 4)))
    top_cls = torch.gather(cls, 1, top_idx)
    det, _ = suppress_and_select(top_boxes, top_conf, top_cls, top_idx, ct,
                                 iou_thres, max_det, class_agnostic)
    return det
