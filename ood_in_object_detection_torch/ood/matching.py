"""Re-homed from ood_in_object_detection_tpu/ood/matching.py unchanged: that
package's ood/__init__.py imports jax, so this NumPy module cannot be
imported from there without it.

Prediction-to-target matching for InD activation extraction.

Semantics parity with reference OODMethod.match_predicted_boxes_to_targets
(ood_utils.py:233-292): IoU matrix x same-class mask, Hungarian assignment
(scipy linear_sum_assignment, maximize), keep predictions whose assigned IoU
exceeds the threshold ("valid preds").

The IoU matrix is computed vectorized (the reference builds the class mask in
a double Python loop); the tiny Hungarian solve stays on host — matching runs
once per batch during offline InD fitting, never in the serving path.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.optimize import linear_sum_assignment


def iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU, torchvision box_iou semantics."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_predictions_to_targets(
    pred_boxes: np.ndarray,   # (N, 4) xyxy
    pred_cls: np.ndarray,     # (N,)
    tgt_boxes: np.ndarray,    # (M, 4) xyxy
    tgt_cls: np.ndarray,      # (M,)
    iou_threshold: float,
) -> List[int]:
    """Indices of valid predictions (reference's ``valid_preds``).

    NOTE the reference indexes the score matrix with the ENUMERATION index of
    assignment[1], not the assignment's row index (ood_utils.py:291-292:
    ``for i, assigment in enumerate(assignment[1]): score_matrix[i, assigment]``).
    With more predictions than targets scipy returns a row subset, so the
    checked pairs are (0..k-1, col_j) rather than (row_j, col_j). We replicate
    this exactly — valid_preds is the contract the InD activations are built
    on; when n <= m both formulations coincide."""
    n, m = len(pred_boxes), len(tgt_boxes)
    if n == 0 or m == 0:
        return []
    score = iou_matrix_np(pred_boxes, tgt_boxes)
    score = score * (pred_cls[:, None] == tgt_cls[None, :])
    rows, cols = linear_sum_assignment(score, maximize=True)
    valid = []
    for i, c in enumerate(cols):
        if score[i, c] > iou_threshold:
            valid.append(int(i))
    return sorted(valid)
