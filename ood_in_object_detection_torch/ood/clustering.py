"""Per-(class, stride) cluster search on the host (offline fit stage).

Port of ood_in_object_detection_tpu/ood/clustering.py (reference
cluster_utils.py:18-366) onto the port's own clusterers, which give
scikit-learn's labels without scikit-learn (the card's machine has none):
``ood/kmeans.py`` (KMeans), ``ood/clusterers.py`` (DBSCAN, complete-linkage
agglomerative clustering, Birch), ``ood/hdbscan.py`` (HDBSCAN),
``ood/cluster_metrics.py`` (silhouette, Calinski-Harabasz) and
``ood/dbcv.py`` (DBCV, a copy of the JAX package's). The clusterers run on
the host in NumPy/SciPy, as the JAX package runs scikit-learn there.

One hyperparameter per algorithm is searched, each candidate labelling is
scored under the reference's validity constraints, and orphans (-1) follow
the configured policy:

    DBSCAN                   eps in concat(linspace(.01,.1,100), (.1,1,100), (1,10,100))
    KMeans                   n_clusters in RANGE_OF_CLUSTERS (2..14)
    KMeans_<k>               fixed k (clamped to the sample count)
    HDBSCAN                  min_cluster_size in range(MIN_SAMPLES, 50)
    AgglomerativeClustering  n_clusters in RANGE_OF_CLUSTERS (linkage=complete)
    Birch                    threshold in linspace(.1, 5, 100)
    'all'                    every sample is its own cluster
    'one'                    handled by the caller (single centroid)

Each grid fits one matrix many times, so a search computes the matrix's
pairwise distances (DBSCAN, HDBSCAN, the silhouette) and its linkage tree
(agglomerative) once and hands them to every candidate; the labels and
scores are those of a fit from scratch.

MeanShift, GMM and BGMM, outside the paper's sweep grid (the JAX package
fits GMM and BGMM with an unseeded RNG, so it holds no fixed answer for
them), and the score-curve plot (CUSTOM_HYP.clusters.VISUALIZE, matplotlib)
are not ported: they raise NotImplementedError naming ROADMAP.md A7c.
"""

from __future__ import annotations

import logging
import warnings
from typing import Optional

import numpy as np

from ..core.config import CUSTOM_HYP, ClustersParams
from .cluster_metrics import (SILHOUETTE_BLOCK_ELEMENTS, as_float_array,
                              calinski_harabasz_score, pairwise_distances, silhouette_samples,
                              silhouette_score)
from .clusterers import DBSCAN, AgglomerativeClustering, Birch, complete_linkage_children
from .hdbscan import HDBSCAN, data_distances
from .kmeans import KMeans

log = logging.getLogger(__name__)

AVAILABLE_CLUSTERING_METHODS = (
    "one", "all", "DBSCAN", "KMeans", "KMeans_3", "KMeans_5", "KMeans_10",
    "HDBSCAN", "AgglomerativeClustering", "Birch", "MeanShift", "GMM", "BGMM",
)
AVAILABLE_CLUSTER_OPTIMIZATION_METRICS = ("silhouette", "calinski_harabasz")
# in AVAILABLE_CLUSTERING_METHODS (the JAX package's list) but not ported
UNPORTED_CLUSTERING_METHODS = ("MeanShift", "GMM", "BGMM")
A7C = "ROADMAP.md A7c: MeanShift, GMM, BGMM and the cluster score-curve plot"

_SKLEARN_METRIC = {"l1": "l1", "l2": "l2", "cosine": "cosine",
                   "manhattan": "manhattan", "euclidean": "euclidean"}


def check_cluster_method(method: str) -> None:
    """Raise for a cluster method the port refuses (and for unknown ones)."""
    if method in UNPORTED_CLUSTERING_METHODS:
        raise NotImplementedError(f"cluster method {method!r} is not ported ({A7C})")
    if method not in AVAILABLE_CLUSTERING_METHODS:
        raise ValueError(f"invalid clustering method: {method}")


def make_each_orphan_own_cluster(labels: np.ndarray) -> np.ndarray:
    """reference cluster_utils.py:189-200."""
    labels = labels.copy()
    orphans = np.where(labels < 0)[0]
    if orphans.size == 0:
        return labels
    start = labels.max()
    for i, pos in enumerate(orphans):
        labels[pos] = start + i + 1
    return labels


class _Shared:
    """Per-search memo of what every candidate of a grid recomputes: the
    pairwise distances of the features and their complete-linkage tree."""

    def __init__(self, feats: np.ndarray):
        self.feats, self.memo = feats, {}

    def get(self, key, make):
        if key not in self.memo:
            self.memo[key] = make()
        return self.memo[key]

    def distances(self, metric: str):
        """pairwise_distances(feats, metric) while its N x N matrix is
        small enough for one silhouette block, else None."""
        if len(self.feats) ** 2 > SILHOUETTE_BLOCK_ELEMENTS:
            return None
        return self.get(("pairwise", metric),
                        lambda: pairwise_distances(self.feats, metric=metric))


def _candidate_grid(method: str, metric: str, hyp: ClustersParams,
                    shared: Optional[_Shared] = None):
    """(estimator factory, list of candidate param dicts, density_based)."""
    check_cluster_method(method)
    sk_metric = _SKLEARN_METRIC.get(metric, metric)
    if method == "DBSCAN":
        eps = np.concatenate([
            np.linspace(0.01, 0.1, 100), np.linspace(0.1, 1, 100), np.linspace(1, 10, 100)
        ])

        def dbscan(p):
            d = None if shared is None else shared.distances(sk_metric)
            return DBSCAN(metric=sk_metric, min_samples=hyp.MIN_SAMPLES, distances=d, **p)

        return dbscan, [{"eps": float(e)} for e in eps], True
    if method == "KMeans":
        return (lambda p: KMeans(random_state=10, **p),
                [{"n_clusters": k} for k in hyp.RANGE_OF_CLUSTERS], False)
    if method == "HDBSCAN":
        hmetric = "euclidean" if metric == "l2" else ("manhattan" if metric == "l1" else metric)

        def hdbscan(p):
            d = None
            if shared is not None and np.isfinite(shared.feats).all():
                d = shared.get(("hdbscan", hmetric),
                               lambda: data_distances(shared.feats, hmetric))
            return HDBSCAN(metric=hmetric, distances=d, **p)

        return hdbscan, [{"min_cluster_size": k} for k in range(hyp.MIN_SAMPLES, 50)], True
    if method == "AgglomerativeClustering":
        def agglomerative(p):
            children = None
            if shared is not None:
                children = shared.get(("linkage", sk_metric), lambda: complete_linkage_children(
                    shared.feats, sk_metric))
            return AgglomerativeClustering(metric=sk_metric, children=children, **p)

        return agglomerative, [{"n_clusters": k} for k in hyp.RANGE_OF_CLUSTERS], False
    if method == "Birch":
        return (lambda p: Birch(branching_factor=50, **p),
                [{"threshold": float(t)} for t in np.linspace(0.1, 5, 100)], False)
    raise ValueError(f"invalid clustering method: {method}")


def _score_labels(
    feats: np.ndarray,
    labels: np.ndarray,
    perf_metric: str,
    metric: str,
    density_based: bool,
    hyp: ClustersParams,
    shared: Optional[_Shared] = None,
) -> Optional[float]:
    """Score one labeling under the reference's validity constraints
    (cluster_utils.py:232-300). None => invalid configuration."""
    n = len(feats)
    uniq = set(labels.tolist())
    if not (1 < len(uniq) < n - 1):
        return None
    f_used, l_used = feats, labels
    if -1 in uniq and hyp.REMOVE_ORPHANS:
        n_orphans = int(np.sum(labels == -1))
        if n_orphans > hyp.MAX_PERCENT_OF_ORPHANS * n:
            return None
        f_used = feats[labels != -1]
        l_used = labels[labels != -1]
    counts = np.unique(labels, return_counts=True)
    for lab, cnt in zip(*counts):
        if lab != -1 and cnt < hyp.MIN_SAMPLES:
            return None
    if not (1 < len(set(l_used.tolist())) < n - 1):
        return None
    if hyp.MAKE_EACH_ORPHAN_EACH_OWN_CLUSTER:
        l_used = make_each_orphan_own_cluster(l_used)
    if density_based and (hyp.REMOVE_ORPHANS or hyp.USE_DENSITY_BASED_METRIC):
        # DBCV validity index, reference cluster_utils.py:273
        # (hdbscan.validity.validity_index with d = feature dimension)
        from .dbcv import validity_index

        try:
            return float(validity_index(f_used.astype(np.float64), l_used,
                                        metric=metric, d=f_used.shape[1]))
        except ValueError:
            return None
    if perf_metric == "silhouette":
        sk_metric = _SKLEARN_METRIC[metric]
        d = shared.distances(sk_metric) if shared is not None and f_used is feats else None
        if d is not None:
            return float(np.mean(silhouette_samples(f_used, l_used, sk_metric, distances=d)))
        return float(silhouette_score(f_used, l_used, metric=sk_metric))
    if perf_metric == "calinski_harabasz":
        return float(calinski_harabasz_score(f_used, l_used))
    raise ValueError(f"invalid perf metric {perf_metric}")


def fit_cluster_labels(
    feats: np.ndarray,
    method: str,
    metric: str,
    perf_metric: str = "silhouette",
    hyp: Optional[ClustersParams] = None,
    tag: str = "",
) -> np.ndarray:
    """Grid-search one hyperparameter and return the best labeling
    (reference find_optimal_number_of_clusters_... cluster_utils.py:18-186)."""
    hyp = hyp or CUSTOM_HYP.clusters
    assert method in AVAILABLE_CLUSTERING_METHODS, method
    check_cluster_method(method)
    if method == "one":
        raise ValueError("'one' is handled by the centroid aggregation caller")
    if method == "all":
        return np.arange(len(feats))
    if method.startswith("KMeans_"):
        k = min(int(method.split("_")[-1]), len(feats))
        return KMeans(n_clusters=k, random_state=10).fit_predict(feats)
    if hyp.VISUALIZE:  # the JAX package plots each grid search's scores
        raise NotImplementedError(f"the cluster score-curve plot is not ported ({A7C})")

    try:
        shared = _Shared(as_float_array(feats))
    except ValueError:
        shared = None
    factory, grid, density_based = _candidate_grid(method, metric, hyp, shared)
    default_score = -1.0 if perf_metric == "silhouette" else 0.0
    best_score, best_params = default_score, None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for params in grid:
            try:
                labels = factory(params).fit_predict(feats)
                s = _score_labels(feats, labels, perf_metric, metric, density_based, hyp,
                                  shared)
            except Exception as e:  # mirror reference's catch-all (:295-298)
                log.debug("cluster config %s failed: %s", params, e)
                s = None
            s = default_score if s is None else s
            if s > best_score:
                best_score, best_params = s, params

    if best_params is None and default_score == -1.0:
        # all configurations degenerate -> single cluster; under
        # calinski_harabasz (default 0) the reference refits the first
        # config instead (cluster_utils.py:176), as the JAX package does
        labels = np.zeros(len(feats), dtype=int)
    elif best_params is None:
        try:
            labels = factory(grid[0]).fit_predict(feats)
        except Exception:
            labels = np.zeros(len(feats), dtype=int)
    else:
        labels = factory(best_params).fit_predict(feats)
    if hyp.MAKE_EACH_ORPHAN_EACH_OWN_CLUSTER:
        labels = make_each_orphan_own_cluster(labels)
    return labels
