"""Plain OoD fit and decisions: MSP and Cosine_cl_stride (cluster method 'one').

Written from the paper's reference (``ood_utils.py``): InD activations are
the taps of the predictions matched to the ground truth, grouped by class
(logits methods) or by class and stride (distance methods, RoI-aligned
features of the box's own level); a group with more than 3 samples gets the
mean of its L2-normalised features as its centroid; a group with more than
5 scores gets a threshold at the 95 % true-positive rate, the 'lower'
percentile (95th of distances, 5th of MSP scores). A box is InD (1) when
its distance lies below its group's threshold (no threshold: OoD), or when
its MSP score is at least its class's threshold (no threshold: InD).
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

MIN_CLUSTER_SAMPLES = 3
MIN_THRESHOLD_SAMPLES = 5
TPR = 0.95


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def msp(logits: np.ndarray, cls: np.ndarray) -> np.ndarray:
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    return p[np.arange(len(cls)), cls]


class Fitted:
    """The fitted state of one method: thresholds and, for cosine, centroids."""

    def __init__(self, method: str, nc: int):
        self.method = method
        self.nc = nc
        self.centroids: Dict = {}
        self.thresholds: Dict = {}

    def fit(self, samples: List[dict]) -> "Fitted":
        """``samples``: one dict a matched box with 'cls', 'level', 'logits' and 'roi'."""
        if self.method == "MSP":
            for c in range(self.nc):
                rows = [s for s in samples if s["cls"] == c]
                if len(rows) > MIN_THRESHOLD_SAMPLES:
                    sc = msp(np.stack([s["logits"] for s in rows]), np.full(len(rows), c))
                    self.thresholds[c] = float(np.percentile(sc, (1 - TPR) * 100, method="lower"))
            return self
        for c in range(self.nc):
            for lv in range(3):
                rows = [s["roi"] for s in samples if s["cls"] == c and s["level"] == lv]
                if len(rows) <= MIN_CLUSTER_SAMPLES:
                    continue
                feats = _normalize(np.stack(rows).astype(np.float32))
                cent = feats.mean(0)
                self.centroids[(c, lv)] = cent
                if len(rows) > MIN_THRESHOLD_SAMPLES:
                    d = 1.0 - feats @ _normalize(cent)
                    self.thresholds[(c, lv)] = float(np.percentile(d, TPR * 100, method="lower"))
        return self

    def decide(self, cls: int, level: int, logits: np.ndarray, roi: np.ndarray) -> int:
        """1 = InD, 0 = OoD."""
        if self.method == "MSP":
            thr = self.thresholds.get(cls, 0.0)
            return int(msp(logits[None], np.array([cls]))[0] >= thr)
        thr = self.thresholds.get((cls, level))
        if thr is None:
            return 0
        d = 1.0 - float(_normalize(roi.astype(np.float32)) @ _normalize(self.centroids[(cls, level)]))
        return int(d < thr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
