"""Re-homed from ood_in_object_detection_tpu/eval/owod_protocol.py unchanged,
so that the port's main path imports nothing of the JAX package.

Open-World Object Detection evaluation protocol (host-side NumPy).

Re-implements, from its observable behavior, the reference protocol in
datasets_utils/owod/owod_evaluation_protocol.py:

- ``voc_ap`` area-under-PR with the standard VOC interpolation
  (reference :373-402) and the VOC-07 11-point variant,
- per-class greedy confidence-sorted TP/FP matching with the VOC ``+1`` pixel
  overlap convention (reference :535-573),
- A-OSE: known-class detections overlapping unknown GT (reference :630-663),
- Wilderness Impact at recall levels (reference :61-91),
- unknown AP at recall levels (reference :36-58),
- the UnSniffer-style evaluation used for the reported U-AP/U-F1/U-PRE/U-REC
  and known mAP (reference :688-807; note these use the VOC-07 metric),
- the COCO-OOD short-circuit: if targets contain only unknown boxes, only the
  U-* metrics are returned (reference :241-253).

Data model (mirrors the accumulator built in ood_utils.py:511-549):
    prediction/target = dict(img_name: str, bboxes: (N,4) xyxy np.ndarray,
                             cls: (N,) np.ndarray, conf: (N,) np.ndarray)
Unknown boxes carry class index UNKNOWN_CLASS_INDEX (80).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

UNKNOWN_CLASS_INDEX = 80
_EPS = np.finfo(np.float64).eps

log = logging.getLogger(__name__)


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """Area under the PR curve, VOC style (reference :373-402)."""
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _overlaps_plus1(bb: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU with the VOC +1 pixel convention (reference :547-566)."""
    ixmin = np.maximum(gt[:, 0], bb[0])
    iymin = np.maximum(gt[:, 1], bb[1])
    ixmax = np.minimum(gt[:, 2], bb[2])
    iymax = np.minimum(gt[:, 3], bb[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    uni = (
        (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
        + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
        - inter
    )
    return inter / uni


def _gt_by_image(all_targets: Sequence[Dict], class_idx: int):
    """{img_name: {'bbox': (M,4), 'det': [bool]*M}} for one class + total count."""
    recs = {}
    npos = 0
    for t in all_targets:
        mask = np.asarray(t["cls"]) == class_idx
        bbox = np.asarray(t["bboxes"], np.float64)[mask]
        recs[t["img_name"]] = {"bbox": bbox, "det": [False] * int(mask.sum())}
        npos += int(mask.sum())
    return recs, npos


def _greedy_match(
    image_names: List[str],
    confs: np.ndarray,
    bbs: np.ndarray,
    class_recs: Dict,
    ovthresh: float,
    skip_missing_images: bool = False,
):
    """Greedy conf-sorted TP/FP marking (reference :527-573). Mutates
    class_recs['det']. Returns tp, fp arrays in sorted order + the sort."""
    order = np.argsort(-confs)
    bbs = bbs[order]
    image_names = [image_names[i] for i in order]
    nd = len(image_names)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        if skip_missing_images and image_names[d] not in class_recs:
            continue
        rec = class_recs[image_names[d]]
        gt = rec["bbox"]
        ovmax, jmax = -np.inf, -1
        if gt.size > 0:
            ov = _overlaps_plus1(bbs[d].astype(np.float64), gt)
            jmax = int(np.argmax(ov))
            ovmax = ov[jmax]
        if ovmax > ovthresh:
            if not rec["det"][jmax]:
                tp[d] = 1.0
                rec["det"][jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0
    return tp, fp, bbs, image_names


def _mark_overlap_with_unknown(
    image_names: List[str], bbs: np.ndarray, unk_recs: Dict, ovthresh: float
) -> np.ndarray:
    """is_unk flags: detection overlaps some unknown GT (reference :630-655)."""
    nd = len(image_names)
    is_unk = np.zeros(nd)
    for d in range(nd):
        rec = unk_recs.get(image_names[d])
        if rec is None or rec["bbox"].size == 0:
            continue
        ov = _overlaps_plus1(bbs[d].astype(np.float64), rec["bbox"])
        if np.max(ov) > ovthresh:
            is_unk[d] = 1.0
    return is_unk


def _collect_class_preds(all_predictions: Sequence[Dict], class_idx: int):
    names, confs, boxes = [], [], []
    for p in all_predictions:
        mask = np.asarray(p["cls"]) == class_idx
        n = int(mask.sum())
        names.extend([p["img_name"]] * n)
        confs.append(np.asarray(p["conf"], np.float64)[mask])
        boxes.append(np.asarray(p["bboxes"], np.float64)[mask])
    confs = np.concatenate(confs) if confs else np.empty(0)
    boxes = np.concatenate(boxes) if boxes else np.empty((0, 4))
    return names, confs, boxes


def voc_eval_class(
    all_predictions: Sequence[Dict],
    all_targets: Sequence[Dict],
    class_idx: int,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
    skip_missing_images: bool = False,
):
    """Evaluate one class. Returns dict with rec, prec, ap, is_unk_sum, n_unk,
    tp_plus_fp_closed, fp_open (reference voc_eval :405-663 and the UnSniffer
    variants :688-1010, which share this logic modulo use_07_metric and the
    missing-image skip)."""
    names, confs, bbs = _collect_class_preds(all_predictions, class_idx)
    class_recs, npos = _gt_by_image(all_targets, class_idx)
    unk_recs, n_unk = _gt_by_image(all_targets, UNKNOWN_CLASS_INDEX)

    if len(names) == 0:
        return None  # caller decides (reference: empty-array append + continue)

    tp, fp, sbbs, snames = _greedy_match(
        names, confs, bbs, class_recs, ovthresh, skip_missing_images
    )
    fpc = np.cumsum(fp)
    tpc = np.cumsum(tp)
    rec = tpc / float(npos) if npos > 0 else np.zeros_like(tpc)
    prec = tpc / np.maximum(tpc + fpc, _EPS)
    ap = voc_ap(rec, prec, use_07_metric)

    if class_idx == UNKNOWN_CLASS_INDEX:
        return dict(rec=rec, prec=prec, ap=ap, is_unk_sum=0, n_unk=n_unk,
                    tp_plus_fp_closed=None, fp_open=None, tp=tp, fp=fp, npos=npos)

    is_unk = _mark_overlap_with_unknown(snames, sbbs, unk_recs, ovthresh)
    return dict(
        rec=rec, prec=prec, ap=ap,
        is_unk_sum=float(np.sum(is_unk)), n_unk=n_unk,
        tp_plus_fp_closed=tpc + fpc, fp_open=np.cumsum(is_unk),
        tp=tp, fp=fp, npos=npos,
    )


def compute_wi_at_recall(
    all_recs: List[np.ndarray],
    tp_plus_fp_cs: List[np.ndarray],
    fp_os: List[np.ndarray],
    num_known: int,
    recall_level: float,
) -> float:
    """Wilderness impact at a recall level (reference :74-91)."""
    tps, fps = [], []
    for cls_id in range(min(num_known, len(all_recs))):
        rec = all_recs[cls_id]
        if rec is None or len(rec) == 0:
            continue
        if tp_plus_fp_cs[cls_id] is None or fp_os[cls_id] is None:
            # a class with predictions but missing open-set curves => reference
            # raises TypeError and records WI=100 for the level (:61-70)
            return 100.0
        index = int(np.argmin(np.abs(np.asarray(rec) - recall_level)))
        tps.append(tp_plus_fp_cs[cls_id][index])
        fps.append(fp_os[cls_id][index])
    if not tps:
        return 0.0
    return float(np.mean(fps) / np.mean(tps))


def compute_unk_ap_at_recall(
    all_precs: List[np.ndarray], all_recs: List[np.ndarray], unk_pos: int, recall_level: float
) -> float:
    """Unknown-class precision at the closest recall level (reference :44-57)."""
    rec = all_recs[unk_pos]
    if rec is None or len(rec) == 0:
        return 0.0
    index = int(np.argmin(np.abs(np.asarray(rec) - recall_level)))
    return float(all_precs[unk_pos][index])


def compute_metrics(
    all_predictions: Sequence[Dict],
    all_targets: Sequence[Dict],
    class_names: Sequence[str],
    known_classes: Sequence[int],
    logger: Optional[logging.Logger] = None,
) -> Dict[str, float]:
    """Full protocol (reference compute_metrics :94-312).

    Returns {'mAP','U-AP','U-F1','U-PRE','U-REC','A-OSE','WI-08'} — or only
    the U-* metrics when the targets contain exclusively unknown boxes
    (COCO-OOD short-circuit, reference :241-253).
    """
    logger = logger or log
    num_known = len(known_classes)
    eval_ids = list(range(num_known)) + [UNKNOWN_CLASS_INDEX]

    # ---- pass 1: Towards-OWOD-style curves (use_07_metric=False) ----
    all_recs: List[Optional[np.ndarray]] = []
    all_precs: List[Optional[np.ndarray]] = []
    tp_plus_fp_cs: List[Optional[np.ndarray]] = []
    fp_os: List[Optional[np.ndarray]] = []
    unk_det_as_known = []
    num_unks = []
    aps = []
    for cls_id in eval_ids:
        r = voc_eval_class(all_predictions, all_targets, cls_id,
                           ovthresh=0.5, use_07_metric=False)
        if r is None:
            logger.info("No predictions for class %s", cls_id)
            all_recs.append(np.empty(0))
            all_precs.append(np.empty(0))
            tp_plus_fp_cs.append(np.empty(0))
            fp_os.append(np.empty(0))
            continue
        aps.append(r["ap"] * 100)
        unk_det_as_known.append(r["is_unk_sum"])
        num_unks.append(r["n_unk"])
        all_recs.append(r["rec"])
        all_precs.append(r["prec"])
        tp_plus_fp_cs.append(r["tp_plus_fp_closed"])
        fp_os.append(r["fp_open"])

    # ---- pass 2: UnSniffer-style metrics (use_07_metric=True) ----
    known_aps_unk = []
    for cls_id in range(num_known):
        r = voc_eval_class(all_predictions, all_targets, cls_id,
                           ovthresh=0.5, use_07_metric=True, skip_missing_images=True)
        known_aps_unk.append(0.0 if r is None else r["ap"] * 100)
    known_map_unksniffer = float(np.mean(known_aps_unk)) if known_aps_unk else 0.0

    r_unk = voc_eval_class(all_predictions, all_targets, UNKNOWN_CLASS_INDEX,
                           ovthresh=0.5, use_07_metric=True, skip_missing_images=True)
    if r_unk is None:
        u_rec = u_pre = u_ap = 0.0
    else:
        stp, sfp = float(np.sum(r_unk["tp"])), float(np.sum(r_unk["fp"]))
        u_rec = stp / r_unk["npos"] if r_unk["npos"] > 0 else 0.0
        u_pre = stp / (stp + sfp) if (stp + sfp) > 0 else 0.0
        u_ap = r_unk["ap"]
    u_f1 = 2 * u_pre * u_rec / (u_pre + u_rec) if (u_pre + u_rec) > 0 else 0.0

    logger.info("UNK (UnSniffer eval): U-AP=%.3f U-F1=%.3f U-PRE=%.3f U-REC=%.3f",
                u_ap * 100, u_f1 * 100, u_pre * 100, u_rec * 100)

    # COCO-OOD short-circuit: no known-class targets at all
    any_known_target = any(
        np.any(np.asarray(t["cls"]) != UNKNOWN_CLASS_INDEX) for t in all_targets
    )
    if not any_known_target:
        return {"U-AP": u_ap, "U-F1": u_f1, "U-PRE": u_pre, "U-REC": u_rec}

    wi_08 = compute_wi_at_recall(all_recs, tp_plus_fp_cs, fp_os, num_known, 0.8)
    a_ose = float(np.sum(unk_det_as_known))

    results = {
        "mAP": known_map_unksniffer / 100,
        "U-AP": u_ap,
        "U-F1": u_f1,
        "U-PRE": u_pre,
        "U-REC": u_rec,
        "A-OSE": a_ose,
        "WI-08": wi_08,
    }
    logger.info("Summary: %s", results)
    return results
