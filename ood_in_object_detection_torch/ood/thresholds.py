"""Re-homed from ood_in_object_detection_tpu/ood/thresholds.py unchanged: that
package's ood/__init__.py imports jax, so this NumPy module cannot be
imported from there without it.

Per-(class, stride) percentile threshold generation + device-side packing.

Semantics parity with reference OODMethod.generate_thresholds
(ood_utils.py:583-637):

- distance methods: thr = percentile(scores, 100*tpr,  method='lower')
- similarity methods: thr = percentile(scores, (1-tpr)*100, method='lower')
- a (class, stride) bucket gets a threshold only with
  > MIN_NUMBER_OF_SAMPLES_FOR_THR samples (custom_hyperparams.py:123, default 5)
- missing threshold => box is always OoD for distance methods
  (ood_utils.py:2173-2180); logits methods are per-class only (no stride axis).

Fit is host-side numpy (offline); `pack_thresholds` produces the padded device
tensor used by the jitted decision kernels (NaN = missing threshold).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

MIN_SAMPLES_FOR_THR = 5
GOOD_NUM_SAMPLES = 25


def percentile_lower(x: np.ndarray, q: float) -> float:
    return float(np.percentile(np.asarray(x), q, method="lower"))


def generate_thresholds_per_class(
    ind_scores: Sequence[np.ndarray],
    tpr: float,
    is_distance: bool,
    min_samples: int = MIN_SAMPLES_FOR_THR,
) -> List[Optional[float]]:
    """Per-class thresholds (logits methods). None = no threshold."""
    q = 100 * tpr if is_distance else (1 - tpr) * 100
    out: List[Optional[float]] = []
    for scores in ind_scores:
        scores = np.asarray(scores)
        if scores.size > min_samples:
            out.append(percentile_lower(scores, q))
        else:
            out.append(None)
    return out


def generate_thresholds_per_class_per_stride(
    ind_scores: Sequence[Sequence[np.ndarray]],
    tpr: float,
    is_distance: bool,
    min_samples: int = MIN_SAMPLES_FOR_THR,
    num_strides: int = 3,
) -> List[List[Optional[float]]]:
    q = 100 * tpr if is_distance else (1 - tpr) * 100
    out: List[List[Optional[float]]] = []
    for per_cls in ind_scores:
        row: List[Optional[float]] = []
        for s in range(num_strides):
            scores = np.asarray(per_cls[s]) if s < len(per_cls) else np.empty(0)
            if scores.size > min_samples:
                row.append(percentile_lower(scores, q))
            else:
                row.append(None)
        out.append(row)
    return out


def pack_thresholds_per_class(thrs: Sequence[Optional[float]]) -> np.ndarray:
    """(nc,) f32 with NaN for missing."""
    return np.array([np.nan if t is None else t for t in thrs], np.float32)


def pack_thresholds_per_class_per_stride(
    thrs: Sequence[Sequence[Optional[float]]],
) -> np.ndarray:
    """(nc, S) f32 with NaN for missing."""
    return np.array(
        [[np.nan if t is None else t for t in row] for row in thrs], np.float32
    )


def thresholds_to_jsonable(thrs) -> Union[list, None]:
    """Reference stores thresholds as JSON with [] for missing
    (ood_evaluation.py:583-590 via data_utils.write_json)."""
    if thrs is None:
        return None
    if isinstance(thrs, (list, tuple)):
        return [thresholds_to_jsonable(t) for t in thrs]
    return float(thrs)


def thresholds_from_jsonable(obj):
    if obj is None or (isinstance(obj, list) and len(obj) == 0):
        return None
    if isinstance(obj, list):
        return [thresholds_from_jsonable(t) for t in obj]
    return float(obj)
