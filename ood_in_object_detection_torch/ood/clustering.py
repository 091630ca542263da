"""Per-(class, stride) cluster search on the host (offline fit stage).

Port of ood_in_object_detection_tpu/ood/clustering.py (reference
cluster_utils.py:18-366) onto the port's own clusterers, which give
scikit-learn's labels without scikit-learn (the card's machine has none):
``ood/kmeans.py`` (KMeans), ``ood/clusterers.py`` (DBSCAN, complete-linkage
agglomerative clustering, Birch), ``ood/hdbscan.py`` (HDBSCAN),
``ood/meanshift.py`` (MeanShift), ``ood/mixture.py`` (GaussianMixture,
BayesianGaussianMixture), ``ood/cluster_metrics.py`` (silhouette,
Calinski-Harabasz) and ``ood/dbcv.py`` (DBCV, a copy of the JAX package's).
The clusterers run on the host in NumPy/SciPy, as the JAX package runs
scikit-learn there.

One hyperparameter per algorithm is searched, each candidate labelling is
scored under the reference's validity constraints, and orphans (-1) follow
the configured policy:

    DBSCAN                   eps in concat(linspace(.01,.1,100), (.1,1,100), (1,10,100))
    KMeans                   n_clusters in RANGE_OF_CLUSTERS (2..14)
    KMeans_<k>               fixed k (clamped to the sample count)
    HDBSCAN                  min_cluster_size in range(MIN_SAMPLES, 50)
    AgglomerativeClustering  n_clusters in RANGE_OF_CLUSTERS (linkage=complete)
    Birch                    threshold in linspace(.1, 5, 100)
    MeanShift                bandwidth=None twice (no search), cluster_all=not REMOVE_ORPHANS
    GMM / BGMM               n_components in RANGE_OF_CLUSTERS, unseeded
    'all'                    every sample is its own cluster
    'one'                    handled by the caller (single centroid)

GMM and BGMM take no seed, as in the JAX package: their k-means
initialisations draw from NumPy's global RandomState, each grid point from
the state the one before it left, and the refit of the best one after them,
so the same ``np.random.seed`` gives the JAX package's labels.

Each grid fits one matrix many times, so a search computes the matrix's
pairwise distances (DBSCAN, HDBSCAN, the silhouette) and its linkage tree
(agglomerative) once and hands them to every candidate; the labels and
scores are those of a fit from scratch.

With CUSTOM_HYP.clusters.VISUALIZE (``--visualize_clusters``) every grid
search plots its scores against the searched parameter
(``_plot_score_curve``).
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
from .meanshift import MeanShift
from .mixture import BayesianGaussianMixture, GaussianMixture

log = logging.getLogger(__name__)

AVAILABLE_CLUSTERING_METHODS = (
    "one", "all", "DBSCAN", "KMeans", "KMeans_3", "KMeans_5", "KMeans_10",
    "HDBSCAN", "AgglomerativeClustering", "Birch", "MeanShift", "GMM", "BGMM",
)
AVAILABLE_CLUSTER_OPTIMIZATION_METRICS = ("silhouette", "calinski_harabasz")

_SKLEARN_METRIC = {"l1": "l1", "l2": "l2", "cosine": "cosine",
                   "manhattan": "manhattan", "euclidean": "euclidean"}


def check_cluster_method(method: str) -> None:
    """Raise ValueError for an unknown cluster method."""
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
    if method == "MeanShift":
        return (lambda p: MeanShift(cluster_all=not hyp.REMOVE_ORPHANS, **p),
                [{"bandwidth": None}, {"bandwidth": None}], False)
    if method == "GMM":
        return (lambda p: GaussianMixture(**p),
                [{"n_components": k} for k in hyp.RANGE_OF_CLUSTERS], False)
    if method == "BGMM":
        return (lambda p: BayesianGaussianMixture(**p),
                [{"n_components": k} for k in hyp.RANGE_OF_CLUSTERS], False)
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


def _plot_score_curve(scores, grid, method: str, perf_metric: str, tag: str):
    """Grid-search score curve vs the searched parameter, saved as
    RESULTS_PATH/cluster_viz/{tag}_{method}_{perf_metric}_scores.png
    (reference plot_scores, cluster_utils.py:342-352; the JAX package's
    _plot_score_curve, a matplotlib figure of 600 x 400 pixels). Drawn with
    Pillow, which draws the port's other PNGs (the card's machine has no
    matplotlib), on a canvas of that size: a framed plot area, the curve
    with a dot at each grid point, the extremes of each axis, the axis
    names and the title."""
    from PIL import Image, ImageDraw

    from .. import constants as C

    xs = [next(iter(p.values())) for p in grid]
    param_name = next(iter(grid[0].keys())) if grid else "param"
    if any(x is None for x in xs):
        xs, param_name = list(range(len(grid))), "config"
    out = C.RESULTS_PATH / "cluster_viz"
    out.mkdir(parents=True, exist_ok=True)

    size = (600, 400)
    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    left, top, right, bottom = 70, 40, size[0] - 20, size[1] - 50
    draw.rectangle((left, top, right, bottom), outline="black")
    xs, ys = np.asarray(xs, np.float64), np.asarray(scores, np.float64)
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    sx = (right - left) / ((x1 - x0) or 1.0)
    sy = (bottom - top) / ((y1 - y0) or 1.0)
    pts = [(left + (x - x0) * sx, bottom - (y - y0) * sy) for x, y in zip(xs, ys)]
    if len(pts) > 1:
        draw.line(pts, fill=(31, 119, 180), width=1)
    for px, py in pts:
        draw.ellipse((px - 2, py - 2, px + 2, py + 2), fill=(31, 119, 180))
    draw.text((left, bottom + 4), f"{x0:g}", fill="black")
    draw.text((right - 30, bottom + 4), f"{x1:g}", fill="black")
    draw.text((4, bottom - 10), f"{y0:.4g}", fill="black")
    draw.text((4, top), f"{y1:.4g}", fill="black")
    draw.text(((left + right) // 2 - 20, size[1] - 20), param_name, fill="black")
    draw.text((4, (top + bottom) // 2), perf_metric, fill="black")
    draw.text((left, 12), f"{tag} {method}", fill="black")
    img.save(out / f"{tag}_{method}_{perf_metric}_scores.png")


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
    try:
        shared = _Shared(as_float_array(feats))
    except ValueError:
        shared = None
    factory, grid, density_based = _candidate_grid(method, metric, hyp, shared)
    default_score = -1.0 if perf_metric == "silhouette" else 0.0
    best_score, best_params = default_score, None
    scores = []
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
            scores.append(s)
            if s > best_score:
                best_score, best_params = s, params

    if hyp.VISUALIZE:
        _plot_score_curve(scores, grid, method, perf_metric, tag or "clusters")

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
