"""Standard detection metrics: mAP@0.5 and mAP@0.5:0.95 (host-side NumPy).

Capability parity with the reference's training-time validator
(ultralytics/engine/validator.py + utils/metrics.py DetMetrics): per-class
AP over IoU thresholds 0.50:0.95:0.05 with greedy confidence-sorted matching
(each GT matched at most once per IoU level) and 101-point interpolation-free
VOC-style area AP (the reference uses continuous interpolation, metrics.py
compute_ap with np.trapz over interpolated envelope — we use the same
envelope-area form as the OWOD protocol for consistency).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .owod_protocol import voc_ap


def _match_one_level(
    pred_boxes, pred_conf, gt_boxes, iou_matrix, thr
) -> np.ndarray:
    """tp flags for one image/class/IoU-threshold, greedy by confidence."""
    order = np.argsort(-pred_conf)
    matched = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(pred_boxes))
    for d in order:
        if len(gt_boxes) == 0:
            continue
        ious = iou_matrix[d]
        j = int(np.argmax(ious))
        if ious[j] >= thr and not matched[j]:
            matched[j] = True
            tp[d] = 1.0
    return tp


def compute_det_metrics(
    all_predictions: Sequence[Dict],
    all_targets: Sequence[Dict],
    num_classes: int,
    iou_thrs: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """-> {'mAP50': ..., 'mAP50_95': ..., 'per_class_ap50': [...]}.

    Data model identical to the OWOD protocol accumulators."""
    from ..ood.matching import iou_matrix_np

    ap_per_class = {t: [] for t in iou_thrs}
    for c in range(num_classes):
        tps = {t: [] for t in iou_thrs}
        confs = []
        npos = 0
        for pred, tgt in zip(all_predictions, all_targets):
            pm = np.asarray(pred["cls"]) == c
            tm = np.asarray(tgt["cls"]) == c
            pb = np.asarray(pred["bboxes"])[pm]
            pc = np.asarray(pred["conf"])[pm]
            gb = np.asarray(tgt["bboxes"])[tm]
            npos += len(gb)
            iou = iou_matrix_np(pb, gb) if len(pb) and len(gb) else \
                np.zeros((len(pb), len(gb)))
            confs.append(pc)
            for t in iou_thrs:
                tps[t].append(_match_one_level(pb, pc, gb, iou, t))
        confs = np.concatenate(confs) if confs else np.empty(0)
        if npos == 0:
            # class absent from the eval set: excluded from the mean like the
            # reference, which averages only over ap_class_index (classes with
            # GT present — utils/metrics.py DetMetrics); kept as NaN per-class
            for t in iou_thrs:
                ap_per_class[t].append(np.nan)
            continue
        if confs.size == 0:
            for t in iou_thrs:
                ap_per_class[t].append(0.0)
            continue
        order = np.argsort(-confs)
        for t in iou_thrs:
            tp = np.concatenate(tps[t])[order]
            fp = 1.0 - tp
            rec = np.cumsum(tp) / npos
            prec = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-12)
            ap_per_class[t].append(voc_ap(rec, prec))

    def _nanmean(vals):
        vals = np.asarray(vals, float)
        return float(np.nanmean(vals)) if np.isfinite(vals).any() else 0.0

    ap50 = _nanmean(ap_per_class[iou_thrs[0]])
    ap_all = _nanmean([_nanmean(ap_per_class[t]) for t in iou_thrs])
    return {"mAP50": ap50, "mAP50_95": ap_all,
            "per_class_ap50": ap_per_class[iou_thrs[0]]}
