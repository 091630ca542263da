"""Mean shift with scikit-learn 1.9's defaults, in NumPy.

Counterpart: scikit-learn's ``cluster/_mean_shift.py``
``MeanShift(bandwidth=None, cluster_all=...)`` as
ood_in_object_detection_tpu/ood/clustering.py calls it:

- the bandwidth is ``estimate_bandwidth(X)``: quantile 0.3, so each
  sample's distance to its ``max(int(0.3 N), 1)``-th nearest neighbour
  (the sample itself counted), averaged over the samples;
- every sample seeds a hill climb (no binning) under a flat kernel: the
  mean moves to the mean of the samples within the bandwidth (distance <=
  bandwidth) until it moves by at most 1e-3 bandwidth, or after
  ``max_iter`` steps; a climb that finds no sample in its window is dropped;
- the climbs' end points, keyed by their exact coordinates, are sorted by
  (samples in the window, coordinates), descending; each keeps its place
  unless an earlier survivor lies within the bandwidth;
- each sample takes the label of its nearest centre, the lower index on a
  tie; with ``cluster_all`` False a sample farther than the bandwidth from
  every centre is an orphan (-1).

Distances are Euclidean whatever the OoD metric, as in scikit-learn. The
climbs run together, in blocks of seeds; a window's mean is its float64
sum over the count, rounded to the data's dtype (scikit-learn's
``np.mean`` adds in the data's dtype), so centres agree to rounding and
labels equal.
"""

from __future__ import annotations

import numpy as np

from .cluster_metrics import as_float_array, check_finite, row_norms

QUANTILE = 0.3
# seeds (and bandwidth rows) per block: a block's distances are SEED_BLOCK x N float64
SEED_BLOCK = 512


def _sq_dist(a64: np.ndarray, x64: np.ndarray, xn: np.ndarray) -> np.ndarray:
    d = row_norms(a64, squared=True)[:, None] - 2 * (a64 @ x64.T)
    d += xn[None, :]
    return np.maximum(d, 0, out=d)


def estimate_bandwidth(x, quantile: float = QUANTILE) -> float:
    """scikit-learn's ``estimate_bandwidth(X, quantile)`` on every sample."""
    x = check_finite(as_float_array(x))
    n = len(x)
    k = max(int(n * quantile), 1)
    x64 = x.astype(np.float64)
    xn = row_norms(x64, squared=True)
    total = 0.0
    for s in range(0, n, SEED_BLOCK):
        d = _sq_dist(x64[s:s + SEED_BLOCK], x64, xn)
        total += np.sqrt(np.partition(d, k - 1, axis=1)[:, k - 1]).sum()
    return total / n


def _climb(x: np.ndarray, bandwidth: float, max_iter: int):
    """Every sample's hill climb -> (end points, samples in the final
    window, completed steps)."""
    n = len(x)
    x64 = x.astype(np.float64)
    xn = row_norms(x64, squared=True)
    r2, stop = bandwidth * bandwidth, 1e-3 * bandwidth
    means = x.copy()
    counts = np.zeros(n, np.int64)
    steps = np.zeros(n, np.int64)
    active = np.arange(n)
    while active.size:
        still = []
        for s in range(0, active.size, SEED_BLOCK):
            idx = active[s:s + SEED_BLOCK]
            old = means[idx]
            within = _sq_dist(old.astype(np.float64), x64, xn) <= r2
            cnt = within.sum(axis=1)
            counts[idx] = cnt
            live = cnt > 0  # an empty window ends the climb where it stands
            idx, old, within, cnt = idx[live], old[live], within[live], cnt[live]
            new = ((within.astype(np.float64) @ x64) / cnt[:, None]).astype(x.dtype)
            means[idx] = new
            done = (np.linalg.norm(new - old, axis=1) <= stop) | (steps[idx] == max_iter)
            steps[idx[~done]] += 1
            still.append(idx[~done])
        active = np.concatenate(still) if still else active[:0]
    return means, counts, steps


class MeanShift:
    """``MeanShift(bandwidth, cluster_all, max_iter).fit(x)`` ->
    ``labels_``, ``cluster_centers_``, ``bandwidth_``, ``n_iter_``."""

    def __init__(self, bandwidth=None, cluster_all: bool = True, max_iter: int = 300):
        self.bandwidth, self.cluster_all, self.max_iter = bandwidth, cluster_all, max_iter

    def fit(self, x) -> "MeanShift":
        x = check_finite(as_float_array(x))
        bw = estimate_bandwidth(x) if self.bandwidth is None else float(self.bandwidth)
        means, counts, steps = _climb(x, bw, self.max_iter)
        intensity = {}
        for m, c in zip(means, counts):
            if c:
                intensity[tuple(m)] = int(c)
        self.n_iter_ = int(steps.max())
        if not intensity:
            raise ValueError(f"No point was within bandwidth={bw:f} of any seed.")
        ranked = sorted(intensity.items(), key=lambda t: (t[1], t[0]), reverse=True)
        centers = np.array([t[0] for t in ranked])
        c64 = centers.astype(np.float64)
        keep = np.ones(len(centers), bool)
        for i in range(len(centers)):
            if keep[i]:
                keep[((c64 - c64[i]) ** 2).sum(axis=1) <= bw * bw] = False
                keep[i] = True
        centers = centers[keep]
        d = _sq_dist(x.astype(np.float64), centers.astype(np.float64),
                     row_norms(centers.astype(np.float64), squared=True))
        labels = np.argmin(d, axis=1)
        if not self.cluster_all:
            labels = np.where(np.sqrt(d[np.arange(len(x)), labels]) <= bw, labels, -1)
        self.bandwidth_, self.cluster_centers_, self.labels_ = bw, centers, labels
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_
