"""DBSCAN, complete-linkage agglomerative clustering and Birch with
scikit-learn 1.9's labels, in NumPy and SciPy (the card's machine has no
scikit-learn). The parameters are those that
ood_in_object_detection_tpu/ood/clustering.py:_candidate_grid (:70-101)
passes; a configuration that makes scikit-learn raise raises here too.

Counterparts in scikit-learn's ``cluster/``:

- ``_dbscan.py`` + ``_dbscan_inner.pyx``: a sample is core when at least
  ``min_samples`` samples (itself included) lie within ``eps`` (``<=``);
  clusters grow from the core samples in index order, so label ``i`` is the
  cluster of the i-th core sample that no earlier cluster reached, and a
  border sample joins the first cluster that reaches it (computed here as
  the connected components of the core samples);
- ``_agglomerative.py``: without connectivity the tree is SciPy's
  ``linkage(X, "complete", metric)`` (:587; l2 -> euclidean,
  l1/manhattan -> cityblock), cut by ``_hc_cut`` (:732), whose heap of
  negated node ids numbers the clusters;
- ``_birch.py``: the CF-tree built by inserting samples one by one
  (``branching_factor`` 50, :46 ``_split_node``, :194 insertion), every
  leaf subcluster its own cluster (``n_clusters=None``), labels the argmin
  over the subcluster centres of ``-2 x.c + |c|^2`` (:657); float32 input
  stays float32 in the tree.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np
from scipy.cluster import hierarchy
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from .cluster_metrics import (METRIC_ALIASES, as_float_array, check_finite,
                              euclidean_distances, pairwise_distances, row_norms)


# distances per block of DBSCAN's neighbourhood search
NEAR_BLOCK_ELEMENTS = 1 << 24


class DBSCAN:
    """``DBSCAN(eps, min_samples, metric).fit_predict(x)``; noise is -1.
    ``distances`` (optional) is ``pairwise_distances(x, metric=metric)``,
    given by a caller that fits one ``x`` at many ``eps``."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5, metric: str = "euclidean",
                 distances: Optional[np.ndarray] = None):
        if not eps > 0:
            raise ValueError(f"eps must be > 0, got {eps}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        if metric not in METRIC_ALIASES:
            raise ValueError(f"unsupported metric {metric!r}")
        self.eps, self.min_samples, self.metric, self.distances = eps, min_samples, metric, distances

    def fit_predict(self, x) -> np.ndarray:
        x = check_finite(as_float_array(x))
        if self.distances is not None:
            near = self.distances <= self.eps
        else:  # blocks of rows: the N x N booleans, never the N x N distances
            rows = max(1, NEAR_BLOCK_ELEMENTS // len(x))
            near = np.concatenate([pairwise_distances(x[r:r + rows], x, self.metric) <= self.eps
                                   for r in range(0, len(x), rows)])
        core = near.sum(axis=1) >= self.min_samples
        labels = np.full(len(x), -1, np.intp)
        idx = np.flatnonzero(core)
        if len(idx):
            # the clusters are the connected components of the core samples,
            # numbered by their first core sample; a border sample joins the
            # lowest-numbered cluster among its core neighbours, the first
            # one scikit-learn's index-order growth reaches it from
            _, comp = connected_components(csr_matrix(near[np.ix_(idx, idx)]), directed=False)
            first = np.full(comp.max() + 1, len(x))
            np.minimum.at(first, comp, idx)
            rank = np.empty_like(first)
            rank[np.argsort(first)] = np.arange(len(first))
            labels[idx] = rank[comp]
            border = np.flatnonzero(~core)
            reach = np.where(near[np.ix_(border, idx)], labels[idx][None, :], len(x)).min(axis=1)
            labels[border] = np.where(reach < len(x), reach, -1)
        self.labels_ = labels
        return labels


_SCIPY_METRIC = {"l2": "euclidean", "euclidean": "euclidean", "l1": "cityblock",
                 "manhattan": "cityblock", "cosine": "cosine"}


def complete_linkage_children(x, metric: str) -> np.ndarray:
    """(N - 1, 2) merges of SciPy's complete-linkage tree."""
    x = check_finite(as_float_array(x))
    if len(x) < 2:
        raise ValueError(f"found array with {len(x)} sample(s); a minimum of 2 is required")
    if metric not in _SCIPY_METRIC:
        raise ValueError(f"unsupported metric {metric!r}")
    return hierarchy.linkage(x, method="complete", metric=_SCIPY_METRIC[metric])[:, :2].astype(int)


def hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """scikit-learn's ``_hc_cut``: undo the last ``n_clusters - 1`` merges,
    largest node first, and number the clusters in heap order."""
    if n_clusters > n_leaves:
        raise ValueError(f"Cannot extract more clusters than samples: {n_clusters} clusters "
                         f"were given for a tree with {n_leaves} leaves.")
    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(these[0]))
        heapq.heappushpop(nodes, -int(these[1]))
    labels = np.zeros(n_leaves, np.intp)
    for i, node in enumerate(nodes):
        todo, leaves = [-node], []
        while todo:
            v = todo.pop()
            if v < n_leaves:
                leaves.append(v)
            else:
                todo.extend(children[v - n_leaves].tolist())
        labels[leaves] = i
    return labels


class AgglomerativeClustering:
    """Complete linkage without connectivity. ``children`` (optional) is
    ``complete_linkage_children(x, metric)``, given by a caller that cuts one
    tree at many ``n_clusters``."""

    def __init__(self, n_clusters: int = 2, metric: str = "euclidean",
                 children: Optional[np.ndarray] = None):
        if not isinstance(n_clusters, (int, np.integer)) or n_clusters < 1:
            raise ValueError(f"n_clusters must be an int >= 1, got {n_clusters!r}")
        self.n_clusters, self.metric, self.children = n_clusters, metric, children

    def fit_predict(self, x) -> np.ndarray:
        children = (self.children if self.children is not None
                    else complete_linkage_children(x, self.metric))
        self.labels_ = hc_cut(self.n_clusters, children, len(children) + 1)
        return self.labels_


class _Subcluster:
    """A CF entry: sample count, linear sum, squared sum, centroid, and the
    child node of a non-leaf entry."""

    def __init__(self, sample=None):
        self.child = None
        if sample is None:
            self.n, self.ss, self.ls = 0, 0.0, 0
            self.centroid = 0
        else:
            self.n = 1
            self.centroid = self.ls = sample
            self.ss = self.sq_norm = np.dot(sample, sample)

    def update(self, other: "_Subcluster") -> None:
        self.n += other.n
        self.ls = self.ls + other.ls if isinstance(self.ls, int) else self.ls.__iadd__(other.ls)
        self.ss += other.ss
        self.centroid = self.ls / self.n
        self.sq_norm = np.dot(self.centroid, self.centroid)

    def try_merge(self, other: "_Subcluster", threshold: float) -> bool:
        ss, ls, n = self.ss + other.ss, self.ls + other.ls, self.n + other.n
        centroid = (1 / n) * ls
        sq_norm = np.dot(centroid, centroid)
        if ss / n - sq_norm <= threshold ** 2:
            self.n, self.ls, self.ss, self.centroid, self.sq_norm = n, ls, ss, centroid, sq_norm
            return True
        return False


class _Node:
    def __init__(self, threshold, branching, is_leaf, n_features, dtype):
        self.threshold, self.branching, self.is_leaf = threshold, branching, is_leaf
        self.subs = []
        self.centroids = np.zeros((branching + 1, n_features), dtype)
        self.sq_norms = np.zeros(branching + 1, dtype)
        self.prev_leaf = self.next_leaf = None

    def append(self, sub: _Subcluster) -> None:
        i = len(self.subs)
        self.subs.append(sub)
        self.centroids[i] = sub.centroid
        self.sq_norms[i] = sub.sq_norm

    def set(self, i: int, sub: _Subcluster) -> None:
        self.subs[i] = sub
        self.centroids[i] = sub.centroid
        self.sq_norms[i] = sub.sq_norm

    def insert(self, sub: _Subcluster) -> bool:
        """-> whether this node now holds too many entries and must split."""
        if not self.subs:
            self.append(sub)
            return False
        n = len(self.subs)
        dist = np.dot(self.centroids[:n], sub.centroid)
        dist *= -2.0
        dist += self.sq_norms[:n]
        i = int(np.argmin(dist))
        closest = self.subs[i]
        if closest.child is not None:
            if not closest.child.insert(sub):
                closest.update(sub)
                self.set(i, closest)
                return False
            s1, s2 = split_node(closest.child, self.threshold, self.branching)
            self.set(i, s1)
            self.append(s2)
            return len(self.subs) > self.branching
        if closest.try_merge(sub, self.threshold):
            self.set(i, closest)
            return False
        self.append(sub)
        return len(self.subs) > self.branching


def split_node(node: _Node, threshold: float, branching: int):
    """Two entries whose children share the node's entries: the farthest
    pair seeds them, every other entry goes to the nearer seed."""
    dtype, nf = node.centroids.dtype, node.centroids.shape[1]
    halves = [_Node(threshold, branching, node.is_leaf, nf, dtype) for _ in range(2)]
    subs = [_Subcluster(), _Subcluster()]
    subs[0].child, subs[1].child = halves
    if node.is_leaf:
        if node.prev_leaf is not None:
            node.prev_leaf.next_leaf = halves[0]
        halves[0].prev_leaf, halves[0].next_leaf = node.prev_leaf, halves[1]
        halves[1].prev_leaf, halves[1].next_leaf = halves[0], node.next_leaf
        if node.next_leaf is not None:
            node.next_leaf.prev_leaf = halves[1]
    n = len(node.subs)
    dist = euclidean_distances(node.centroids[:n], squared=True)
    far = np.unravel_index(dist.argmax(), (n, n))
    d1, d2 = dist[(far,)]
    first = d1 < d2
    first[far[0]] = True
    for i, sub in enumerate(node.subs):
        k = 0 if first[i] else 1
        halves[k].append(sub)
        subs[k].update(sub)
    return subs[0], subs[1]


class Birch:
    """``Birch(threshold, branching_factor=50)``: every leaf subcluster of
    the CF-tree is a cluster (scikit-learn's ``n_clusters=None``)."""

    def __init__(self, threshold: float = 0.5, branching_factor: int = 50):
        if not threshold > 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if branching_factor <= 1:
            raise ValueError(f"branching_factor must be > 1, got {branching_factor}")
        self.threshold, self.branching = threshold, branching_factor

    def fit_predict(self, x) -> np.ndarray:
        x = check_finite(as_float_array(x)).copy()
        t, b, nf = self.threshold, self.branching, x.shape[1]
        root = _Node(t, b, True, nf, x.dtype)
        head = _Node(t, b, True, nf, x.dtype)
        head.next_leaf, root.prev_leaf = root, head
        for sample in x:
            if root.insert(_Subcluster(sample)):
                s1, s2 = split_node(root, t, b)
                root = _Node(t, b, False, nf, x.dtype)
                root.append(s1)
                root.append(s2)
        leaves, leaf = [], head.next_leaf
        while leaf is not None:
            leaves.append(leaf.centroids[:len(leaf.subs)])
            leaf = leaf.next_leaf
        centers = np.concatenate(leaves)
        self.subcluster_centers_ = centers
        c = centers.astype(np.float64)
        # the centres' squared norms in the input's dtype, as scikit-learn keeps them
        d = -2 * (x.astype(np.float64) @ c.T) + row_norms(centers, squared=True)[None, :]
        self.labels_ = np.argmin(d, axis=1)
        return self.labels_
