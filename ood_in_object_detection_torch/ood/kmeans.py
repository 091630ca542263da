"""k-means with scikit-learn 1.9's defaults, in NumPy.

Counterpart: scikit-learn's ``cluster/_kmeans.py`` ``KMeans(n_clusters,
random_state)`` with ``init="k-means++"``, ``n_init="auto"`` (one run for
k-means++), ``algorithm="lloyd"``, ``tol=1e-4``, ``max_iter=300``, as
ood_in_object_detection_tpu/ood/clustering.py (``KMeans``, ``KMeans_<k>``)
and ood/unknown.py:175-181 (the k_means thresholder) call it. The same seed
gives the same labels, centres (to rounding) and iteration count:

- the data is centred on its mean before the fit and the mean is added back
  to the centres;
- k-means++ draws from ``np.random.RandomState(random_state)``: the first
  centre by ``choice``, then ``2 + int(log k)`` local trials per centre,
  ``uniform * potential`` searched in the cumulative closest squared
  distances, the trial that lowers the potential most kept;
- the tolerance is ``tol * mean(var(X, axis=0))``;
- Lloyd stops when the labels do not change ("strict convergence") or when
  the centres' total squared shift is at most the tolerance; in the latter
  case one more assignment step relabels against the final centres;
- an empty cluster takes the sample farthest from its own centre;
- float32 input is computed in float32 (its squared distances in float64
  blocks, rounded to float32, in the initialisation).
"""

from __future__ import annotations

import numpy as np

from .cluster_metrics import as_float_array, check_finite, euclidean_distances, row_norms

# samples per block of the assignment step (scikit-learn's CHUNK_SIZE): the
# new centres are summed per block, then the blocks are summed
CHUNK = 256
MAX_ITER, TOL = 300, 1e-4


def kmeans_plusplus(x: np.ndarray, k: int, rng: np.random.RandomState) -> np.ndarray:
    n = len(x)
    w = np.ones(n, dtype=x.dtype)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    first = rng.choice(n, p=w / w.sum())
    centers[0] = x[first]
    xn = row_norms(x, squared=True)
    closest = _sq_dist(x[[first]], x, xn)
    pot = closest @ w
    for c in range(1, k):
        vals = rng.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(w * closest), vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        d = _sq_dist(x[ids], x, xn)
        np.minimum(closest, d, out=d)
        pots = d @ w.reshape(-1, 1)
        best = int(np.argmin(pots))
        pot = pots[best]
        closest = d[best]
        centers[c] = x[ids[best]]
    return centers


def _sq_dist(a: np.ndarray, x: np.ndarray, xn: np.ndarray) -> np.ndarray:
    """Squared euclidean distances of ``a``'s rows to ``x``'s rows; float64
    data uses the precomputed squared norms of ``x``."""
    if x.dtype == np.float32:
        return euclidean_distances(a, x, squared=True)
    d = -2 * (a @ x.T)
    d += row_norms(a, squared=True)[:, None]
    d += xn[None, :]
    np.maximum(d, 0, out=d)
    return d


def _assign(x: np.ndarray, centers: np.ndarray, update: bool):
    """One Lloyd step: labels, and with ``update`` the per-label sums and
    counts, in blocks of CHUNK samples."""
    n, k = len(x), len(centers)
    cn = row_norms(centers, squared=True)
    labels = np.empty(n, np.int32)
    sums = np.zeros_like(centers)
    counts = np.zeros(k, x.dtype)
    for s in range(0, n, CHUNK):
        xb = x[s:s + CHUNK]
        d = cn[None, :] - 2 * (xb @ centers.T).astype(x.dtype, copy=False)
        lb = np.argmin(d, axis=1).astype(np.int32)
        labels[s:s + CHUNK] = lb
        if update:
            bs = np.zeros_like(centers)
            np.add.at(bs, lb, xb)
            sums += bs
            counts += np.bincount(lb, minlength=k).astype(x.dtype)
    return labels, sums, counts


def _m_step(x, centers_old, sums, counts, labels):
    """New centres from the sums; an empty cluster takes the sample farthest
    from its centre (the farthest ones first, for several empties)."""
    empty = np.where(counts == 0)[0]
    if len(empty):
        dist = ((x - centers_old[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if dist.max() != 0:
            for e, f in zip(empty, far):
                old = labels[f]
                sums[old] -= x[f]
                sums[e] = x[f]
                counts[e] = 1
                counts[old] -= 1
    heavy = int(np.argmax(counts))
    for j in range(len(sums)):  # in place and in order, as scikit-learn averages
        if counts[j] > 0:
            sums[j] *= x.dtype.type(1.0) / counts[j]
        else:
            sums[j] = sums[heavy]
    return sums


class KMeans:
    """``KMeans(n_clusters, random_state).fit(x)`` -> ``labels_``,
    ``cluster_centers_``, ``n_iter_``, ``inertia_``."""

    def __init__(self, n_clusters: int = 8, random_state=None):
        self.n_clusters, self.random_state = n_clusters, random_state

    def fit(self, x) -> "KMeans":
        x = check_finite(as_float_array(x)).copy()
        k = self.n_clusters
        if not isinstance(k, (int, np.integer)) or k < 1:
            raise ValueError(f"n_clusters must be an int >= 1, got {k!r}")
        if len(x) < k:
            raise ValueError(f"n_samples={len(x)} should be >= n_clusters={k}.")
        tol = float(np.mean(np.var(x, axis=0)) * TOL)
        rs = self.random_state
        rng = rs if isinstance(rs, np.random.RandomState) else np.random.RandomState(rs)
        mean = x.mean(axis=0)
        x -= mean
        centers = kmeans_plusplus(x, k, rng)
        labels_old = np.full(len(x), -1, np.int32)
        strict = False
        for it in range(MAX_ITER):
            labels, sums, counts = _assign(x, centers, update=True)
            new = _m_step(x, centers, sums, counts, labels)
            shift = np.sqrt(((new - centers) ** 2).sum(axis=1)).astype(x.dtype)
            centers = new
            if np.array_equal(labels, labels_old):
                strict = True
                break
            if (shift ** 2).sum() <= tol:
                break
            labels_old[:] = labels
        if not strict:
            labels = _assign(x, centers, update=False)[0]
        self.inertia_ = float(((x - centers[labels]) ** 2).sum())
        self.labels_ = labels
        self.cluster_centers_ = centers + mean
        self.n_iter_ = it + 1
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_
