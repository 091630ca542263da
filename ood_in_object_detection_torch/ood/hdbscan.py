"""HDBSCAN with scikit-learn 1.9's labels, in NumPy and SciPy (the card's
machine has no scikit-learn).

Counterpart: scikit-learn's ``cluster/_hdbscan/`` with the parameters that
ood_in_object_detection_tpu/ood/clustering.py:_candidate_grid passes:
``HDBSCAN(metric, min_cluster_size)``, so ``min_samples = min_cluster_size``,
``cluster_selection_method="eom"``, ``allow_single_cluster=False``,
``alpha=1``, no epsilon and no maximum cluster size.

- ``hdbscan.py:838-860``: euclidean and manhattan (in ``FAST_METRICS``)
  take Prim's MST on the data matrix (``_linkage.pyx:mst_from_data_matrix``)
  with core distances from the k nearest neighbours, the point itself
  included; cosine takes the brute path: the dense mutual-reachability
  matrix (``_reachability.pyx``) and its MST
  (``_linkage.pyx:mst_from_mutual_reachability``);
- the MST's edges sorted by distance (NumPy's default argsort, as
  scikit-learn sorts them) make the single-linkage tree
  (``make_single_linkage``, union-find with new ids n, n+1, ...);
- ``_tree.pyx``: the condensed tree (``_condense_tree``), the clusters'
  stabilities, the excess-of-mass selection and the labelling
  (``_do_labelling``, a rank-based union-find), noise -1; rows with a NaN
  are labelled -3 and rows with an infinity -2 after a fit on the rest.

Pairwise distances are SciPy's ``cdist`` for euclidean and manhattan (the
same sums, in the same order, as scikit-learn's ``DistanceMetric``) and
``cluster_metrics.cosine_distances`` for cosine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial.distance import cdist

from .cluster_metrics import cosine_distances

_PRIM_METRIC = {"euclidean": "euclidean", "l2": "euclidean", "manhattan": "cityblock",
                "l1": "cityblock", "cityblock": "cityblock"}


def data_distances(x: np.ndarray, metric: str) -> np.ndarray:
    """The (N, N) float64 distances the fit of ``metric`` starts from."""
    x = np.asarray(x, np.float64)
    if metric in _PRIM_METRIC:
        return cdist(x, x, _PRIM_METRIC[metric])
    if metric == "cosine":
        return cosine_distances(x)
    raise ValueError(f"unsupported metric {metric!r}")


def _core_distances(d: np.ndarray, min_samples: int) -> np.ndarray:
    return np.ascontiguousarray(np.partition(d, min_samples - 1, axis=1)[:, min_samples - 1])


def mst_prim_data(d: np.ndarray, core: np.ndarray) -> np.ndarray:
    """Prim's MST over mutual reachability max(core_i, core_j, d_ij), grown
    from sample 0; a new sample is the first one, in index order, at the
    least reachability. -> (N - 1, 3) rows (source, new, distance)."""
    n = len(d)
    mst = np.empty((n - 1, 3))
    in_tree = np.zeros(n, bool)
    reach = np.full(n, np.inf)
    source = np.ones(n, np.int64)
    cur = 0
    for i in range(n - 1):
        in_tree[cur] = True
        mr = np.maximum(np.maximum(core[cur], core), d[cur])
        upd = ~in_tree & (mr < reach)
        reach[upd] = mr[upd]
        source[upd] = cur
        cand = np.where(in_tree, np.inf, reach)
        new = int(np.argmin(cand))
        if not cand[new] < np.finfo(np.float64).max:
            new = 0  # nothing reachable: scikit-learn's initial values
            mst[i] = (0, 0, np.finfo(np.float64).max)
        else:
            mst[i] = (source[new], new, cand[new])
        cur = new
    return mst


def mst_mutual_reachability(mr: np.ndarray) -> np.ndarray:
    """The brute path's MST over a dense mutual-reachability matrix."""
    n = len(mr)
    mst = np.empty((n - 1, 3))
    labels = np.arange(n, dtype=np.int64)
    cur = 0
    reach = np.full(n, np.inf)
    for i in range(n - 1):
        keep = labels != cur
        labels = labels[keep]
        reach = np.minimum(reach[keep], mr[cur][labels])
        j = int(np.argmin(reach))
        new = int(labels[j])
        mst[i] = (cur, new, reach[j])
        cur = new
    return mst


def single_linkage(mst: np.ndarray) -> np.ndarray:
    """-> (N - 1, 4) rows (left, right, distance, size) of the dendrogram of
    the MST's edges sorted by distance."""
    mst = mst[np.argsort(np.ascontiguousarray(mst[:, 2]))]
    n = len(mst) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    out = np.zeros((n - 1, 4))

    def find(v):
        root = v
        while parent[root] != -1:
            root = parent[root]
        while v != root and parent[v] != root:
            v, parent[v] = parent[v], root
        return root

    for i, (a, b, dist) in enumerate(mst):
        ra, rb = find(int(a)), find(int(b))
        out[i] = (ra, rb, dist, size[ra] + size[rb])
        parent[ra] = parent[rb] = n + i
        size[n + i] = size[ra] + size[rb]
    return out


def _bfs_hierarchy(tree: np.ndarray, root: int, n: int) -> list:
    queue, out = [root], []
    while queue:
        out.extend(queue)
        inner = [v - n for v in queue if v >= n]
        queue = [int(c) for v in inner for c in tree[v, :2]]
    return out


def condense_tree(tree: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """-> (M, 4) rows (parent, child, lambda, child size) of the condensed
    tree; clusters are numbered from n (the root) upwards."""
    n = len(tree) + 1
    root = 2 * (n - 1)
    nodes = _bfs_hierarchy(tree, root, n)
    relabel = np.zeros(root + 1, np.int64)
    relabel[root] = n
    nxt = n + 1
    ignore = np.zeros(len(nodes), bool)
    rows = []

    def size(v):
        return int(tree[v - n, 3]) if v >= n else 1

    def drop(parent_label, sub, lam):
        for v in _bfs_hierarchy(tree, sub, n):
            if v < n:
                rows.append((parent_label, v, lam, 1))
            ignore[v] = True

    for node in nodes:
        if ignore[node] or node < n:
            continue
        left, right, dist = int(tree[node - n, 0]), int(tree[node - n, 1]), tree[node - n, 2]
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = size(left), size(right)
        p = relabel[node]
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[left] = nxt
            rows.append((p, nxt, lam, lc))
            relabel[right] = nxt + 1
            rows.append((p, nxt + 1, lam, rc))
            nxt += 2
        elif lc < min_cluster_size and rc < min_cluster_size:
            drop(p, left, lam)
            drop(p, right, lam)
        elif lc < min_cluster_size:
            relabel[right] = p
            drop(p, left, lam)
        else:
            relabel[left] = p
            drop(p, right, lam)
    return np.array(rows, dtype=np.float64).reshape(-1, 4)


def _stability(ct: np.ndarray) -> dict:
    parents, children = ct[:, 0].astype(np.int64), ct[:, 1].astype(np.int64)
    smallest = int(parents.min())
    births = np.full(max(int(children.max()), smallest) + 1, np.nan)
    births[children] = ct[:, 2]
    births[smallest] = 0.0
    result = np.zeros(int(parents.max()) - smallest + 1)
    for p, lam, sz in zip(parents, ct[:, 2], ct[:, 3]):
        result[p - smallest] += (lam - births[p]) * sz
    return {i + smallest: result[i] for i in range(len(result))}


def _bfs_cluster_tree(ct: np.ndarray, root: int) -> list:
    parents, children = ct[:, 0].astype(np.int64), ct[:, 1].astype(np.int64)
    out, queue = [], np.array([root])
    while len(queue):
        out.extend(queue.tolist())
        queue = children[np.isin(parents, queue)]
    return out


class _RankUnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.rank = np.zeros(n, np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            x, self.parent[x] = self.parent[x], root
        return int(root)

    def union(self, x: int, y: int) -> None:
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1


def eom_labels(ct: np.ndarray) -> np.ndarray:
    """Excess-of-mass selection without a single cluster, then each sample's
    selected cluster (numbered in sorted id order) or -1."""
    stability = _stability(ct)
    nodes = sorted(stability, reverse=True)[:-1]
    tree = ct[ct[:, 3] > 1]
    is_cluster = {c: True for c in nodes}
    tparents = tree[:, 0].astype(np.int64)
    tchildren = tree[:, 1].astype(np.int64)
    for node in nodes:
        sub = np.sum([stability[c] for c in tchildren[tparents == node]])
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            for v in _bfs_cluster_tree(tree, node):
                if v != node:
                    is_cluster[v] = False
    clusters = {c for c in is_cluster if is_cluster[c]}
    cmap = {c: i for i, c in enumerate(sorted(clusters))}
    parents, children = ct[:, 0].astype(np.int64), ct[:, 1].astype(np.int64)
    root = int(parents.min())
    uf = _RankUnionFind(int(parents.max()) + 1)
    for p, c in zip(parents, children):
        if c not in clusters:
            uf.union(int(p), int(c))
    labels = np.empty(root, np.intp)
    for i in range(root):
        c = uf.find(i)
        labels[i] = -1 if c == root else cmap[c]
    return labels


class HDBSCAN:
    """``HDBSCAN(min_cluster_size, metric).fit_predict(x)``. ``distances``
    (optional) is ``data_distances(x, metric)`` of the finite rows, given by
    a caller that fits one ``x`` at many ``min_cluster_size``."""

    def __init__(self, min_cluster_size: int = 5, metric: str = "euclidean",
                 distances: Optional[np.ndarray] = None):
        if not isinstance(min_cluster_size, (int, np.integer)) or min_cluster_size < 2:
            raise ValueError(f"min_cluster_size must be an int >= 2, got {min_cluster_size!r}")
        if metric not in _PRIM_METRIC and metric != "cosine":
            raise ValueError(f"unsupported metric {metric!r}")
        # scikit-learn's min_samples=None: min_samples = min_cluster_size
        self.min_cluster_size = self.min_samples = min_cluster_size
        self.metric, self.distances = metric, distances

    def fit_predict(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
            raise ValueError(f"expected a non-empty 2-D array, got shape {x.shape}")
        rowsum = x.sum(axis=1)
        finite = np.isfinite(rowsum)
        xf = x[finite]
        if len(xf) == 1:
            raise ValueError("n_samples=1 while HDBSCAN requires more than one sample")
        if self.min_samples > len(xf):
            raise ValueError(f"min_samples ({self.min_samples}) must be at most the number "
                             f"of samples in X ({len(xf)})")
        d = self.distances if self.distances is not None else data_distances(xf, self.metric)
        if self.metric in _PRIM_METRIC:
            mst = mst_prim_data(d, _core_distances(d, self.min_samples))
        else:
            core = _core_distances(d, self.min_samples)
            mr = np.maximum(np.maximum(core[:, None], core[None, :]), d)
            mst = mst_mutual_reachability(mr)
        fitted = eom_labels(condense_tree(single_linkage(mst), self.min_cluster_size))
        labels = np.full(len(x), -3, np.intp)
        labels[finite] = fitted
        labels[~finite & ~np.isnan(rowsum)] = -2
        self.labels_ = labels
        return labels
