"""Density-Based Clustering Validation (DBCV) index in NumPy/SciPy.

Re-implements the validity index the reference takes from the hdbscan package
(cluster_utils.py:273 ``hdbscan.validity.validity_index(X, labels, metric,
d=X.shape[1])``; the hdbscan package is not in this environment). Algorithm:
Moulavi et al., "Density-Based Clustering Validation", SDM 2014 —

1. all-points core distance per point within its cluster:
   ``((sum_{y != x} (1/d(x,y))^d) / (n-1))^(-1/d)``
2. mutual reachability ``mr(x,y) = max(core(x), core(y), d(x,y))``
3. density sparseness of a cluster = max *internal* edge of the mutual-
   reachability MST (internal = both endpoints have MST degree > 1)
4. density separation of two clusters = min mutual reachability between
   their internal nodes
5. validity of a cluster ``V = (min_sep - sparseness) / max(min_sep,
   sparseness)``; index = size-weighted sum over clusters (noise points
   count in the total weight but form no cluster).

Result is in [-1, 1]; higher = better density-based clustering.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.sparse.csgraph import minimum_spanning_tree
from scipy.spatial.distance import cdist

_CDIST_METRIC = {"l1": "cityblock", "l2": "euclidean", "cosine": "cosine",
                 "euclidean": "euclidean", "cityblock": "cityblock",
                 "manhattan": "cityblock"}


def _all_points_core_distance(dists: np.ndarray, d: float) -> np.ndarray:
    """(n, n) in-cluster distance matrix -> (n,) core distances."""
    n = dists.shape[0]
    if n <= 1:
        return np.zeros(n)
    inv = np.zeros_like(dists)
    nz = dists != 0
    inv[nz] = (1.0 / dists[nz]) ** d
    s = inv.sum(axis=1) / (n - 1)
    with np.errstate(divide="ignore"):
        return np.where(s > 0, s ** (-1.0 / d), 0.0)


def _mutual_reachability(dists: np.ndarray, core: np.ndarray) -> np.ndarray:
    return np.maximum(np.maximum(core[:, None], core[None, :]), dists)


def _internal_mst(mr: np.ndarray) -> Tuple[np.ndarray, float]:
    """-> (internal node indices, density sparseness = max internal MST edge)."""
    n = mr.shape[0]
    if n == 1:
        return np.array([0]), 0.0
    mst = minimum_spanning_tree(mr).toarray()
    sym = mst + mst.T
    degrees = (sym > 0).sum(axis=1)
    internal = np.where(degrees > 1)[0]
    if len(internal) == 0:  # tiny cluster (n<=2): fall back to all nodes/edges
        return np.arange(n), float(mst.max())
    internal_edges = sym[np.ix_(internal, internal)]
    dsc = float(internal_edges.max()) if (internal_edges > 0).any() else float(mst.max())
    return internal, dsc


def validity_index(X: np.ndarray, labels: np.ndarray,
                   metric: str = "euclidean", d: Optional[float] = None) -> float:
    """DBCV score of a labeling (noise label -1 allowed; weights the total)."""
    X = np.asarray(X, np.float64)
    labels = np.asarray(labels)
    d = float(d if d is not None else X.shape[1])
    cdist_metric = _CDIST_METRIC.get(metric, metric)
    cluster_ids = [c for c in np.unique(labels) if c != -1]
    if len(cluster_ids) < 2:
        raise ValueError("DBCV needs at least 2 non-noise clusters")

    per: Dict[int, dict] = {}
    for c in cluster_ids:
        pts = X[labels == c]
        dists = cdist(pts, pts, metric=cdist_metric)
        core = _all_points_core_distance(dists, d)
        mr = _mutual_reachability(dists, core)
        internal, dsc = _internal_mst(mr)
        per[c] = dict(pts=pts, core=core, internal=internal, dsc=dsc)

    score = 0.0
    n_total = len(labels)
    for c in cluster_ids:
        seps = []
        pi = per[c]["pts"][per[c]["internal"]]
        ci = per[c]["core"][per[c]["internal"]]
        for o in cluster_ids:
            if o == c:
                continue
            pj = per[o]["pts"][per[o]["internal"]]
            cj = per[o]["core"][per[o]["internal"]]
            dd = cdist(pi, pj, metric=cdist_metric)
            mr = np.maximum(np.maximum(ci[:, None], cj[None, :]), dd)
            seps.append(float(mr.min()))
        min_sep = min(seps)
        dsc = per[c]["dsc"]
        denom = max(min_sep, dsc)
        v = 0.0 if denom == 0 else (min_sep - dsc) / denom
        score += (labels == c).sum() / n_total * v
    return float(score)
