"""Score-level OoD metrics: AUROC / FPR@TPR / AUPR.

The reference evaluates via the OWOD detection protocol (owod_protocol.py);
BASELINE.json's parity contract also names AUROC/FPR95 over the OoD scores,
which these helpers provide: feed them the per-box scores collected on an
in-distribution set (positives) and an OoD set (negatives). Convention:
higher score = more in-distribution (pass distance scores negated).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def auroc(ind_scores: np.ndarray, ood_scores: np.ndarray) -> float:
    """Area under ROC via the Mann-Whitney U statistic (ties count half)."""
    x = np.asarray(ind_scores, np.float64)
    y = np.asarray(ood_scores, np.float64)
    if x.size == 0 or y.size == 0:
        return float("nan")
    all_s = np.concatenate([x, y])
    order = np.argsort(all_s, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, all_s.size + 1)
    # average ranks for ties
    sorted_s = all_s[order]
    i = 0
    while i < len(sorted_s):
        j = i
        while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + j) / 2 + 1
        i = j + 1
    r_pos = ranks[: x.size].sum()
    u = r_pos - x.size * (x.size + 1) / 2
    return float(u / (x.size * y.size))


def fpr_at_tpr(ind_scores: np.ndarray, ood_scores: np.ndarray,
               tpr: float = 0.95) -> float:
    """FPR when the threshold keeps ``tpr`` of the InD scores (FPR95)."""
    x = np.asarray(ind_scores, np.float64)
    y = np.asarray(ood_scores, np.float64)
    if x.size == 0 or y.size == 0:
        return float("nan")
    thr = np.percentile(x, (1 - tpr) * 100, method="lower")
    return float(np.mean(y >= thr))


def aupr(ind_scores: np.ndarray, ood_scores: np.ndarray) -> float:
    """Area under precision-recall with InD as the positive class."""
    x = np.asarray(ind_scores, np.float64)
    y = np.asarray(ood_scores, np.float64)
    if x.size == 0 or y.size == 0:
        return float("nan")
    scores = np.concatenate([x, y])
    labels = np.concatenate([np.ones_like(x), np.zeros_like(y)])
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    prec = tp / np.maximum(tp + fp, 1e-12)
    rec = tp / x.size
    # step integration over recall
    return float(np.sum(np.diff(np.concatenate([[0.0], rec])) * prec))


def ood_score_metrics(ind_scores: Sequence[float], ood_scores: Sequence[float],
                      tpr: float = 0.95) -> Dict[str, float]:
    return {
        "AUROC": auroc(np.asarray(ind_scores), np.asarray(ood_scores)),
        f"FPR{int(tpr * 100)}": fpr_at_tpr(np.asarray(ind_scores),
                                           np.asarray(ood_scores), tpr),
        "AUPR": aupr(np.asarray(ind_scores), np.asarray(ood_scores)),
    }


def collect_box_scores(detector, batches, method, conf_thr: float = 0.15):
    """Per-box raw OoD scores over a dataset (higher = more InD): logits
    methods return their score directly; distance methods the negated min
    centroid distance (an SDR method's in its embedded space). Threshold-free
    — works before fit_ind_pipeline (distance methods still need fitted
    clusters). Fusion methods have no raw score; their fitted INDness is used
    instead. Port of ood_in_object_detection_tpu/eval/ood_metrics.py:81-112
    onto the port's ``Detector.predict``."""
    from ..ood.methods import FusionOODMethod
    from ..ood.pipeline import _decisions_for_method, _np, _predict_step

    neck_ch = detector.neck_channels()
    step = _predict_step(detector, conf_thr)
    is_fusion = isinstance(method, FusionOODMethod)
    if is_fusion and not all(getattr(m, "thresholds", None) is not None for m in method.methods):
        raise ValueError("fusion INDness needs fitted thresholds (run fit_ind_pipeline)")
    out_scores = []
    for batch in batches:
        out = step(batch["images"])
        if is_fusion:
            ind = _np(_decisions_for_method(method, out, neck_ch, want_scores=True))
        else:
            ind = _np(_decisions_for_method(method, out, neck_ch, raw=True))
        valid = _np(out.det.valid)
        bmask = batch.get("batch_mask", np.ones(len(valid), bool))
        for i in range(len(valid)):
            if not bmask[i]:
                continue
            n = int(valid[i].sum())
            out_scores.extend(ind[i, :n].tolist())
    return np.asarray(out_scores, np.float64)
