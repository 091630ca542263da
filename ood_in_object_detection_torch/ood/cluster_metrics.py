"""Pairwise distances and cluster scores with scikit-learn's semantics, in
NumPy (the card's machine has no scikit-learn).

Counterparts (scikit-learn 1.9): ``metrics/pairwise.py`` (``row_norms``,
``euclidean_distances`` with its float32 path, ``cosine_distances``,
``pairwise_distances``) and
``metrics/cluster/_unsupervised.py`` (``silhouette_samples`` :211,
``silhouette_score``, ``calinski_harabasz_score``), as
ood_in_object_detection_tpu/ood/clustering.py:145-148 calls them.

What the clusterers' choices depend on is kept as scikit-learn computes it:

- float32 euclidean distances are computed on float64 copies of row blocks
  and rounded to float32 (the matrix keeps the input's dtype); float64 input
  takes ``-2 X Y^T + |x|^2 + |y|^2`` directly. Both clamp at 0 and zero the
  diagonal of ``X`` against itself;
- cosine distances are ``1 - x.y / (|x| |y|)`` (a zero row keeps norm 1),
  clipped to [0, 2], with a zero diagonal against itself;
- manhattan distances are scipy's ``cdist(..., 'cityblock')``;
- the silhouette sums each row's distances per label (float64 ``bincount``)
  into the distances' dtype, as scikit-learn does; a label of -1 is one more
  cluster. Its N x N matrix is computed in blocks of rows, at most
  ``SILHOUETTE_BLOCK_ELEMENTS`` distances at once (a group of N <= 4096
  samples is one block, as in scikit-learn);
- Calinski-Harabasz is computed in float64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy.spatial.distance import cdist

# the distances of one silhouette block: 4096 x 4096 (128 MiB in float64);
# a group of at most 4096 samples is one block, as in scikit-learn
SILHOUETTE_BLOCK_ELEMENTS = 4096 * 4096

METRIC_ALIASES = {"l1": "manhattan", "manhattan": "manhattan", "cityblock": "manhattan",
                  "l2": "euclidean", "euclidean": "euclidean", "cosine": "cosine"}


def as_float_array(x) -> np.ndarray:
    """A 2-D float array as scikit-learn's check_array leaves it: float32
    and float64 keep their dtype, anything else becomes float64."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {x.shape}")
    return x


def check_finite(x: np.ndarray) -> np.ndarray:
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"found array with shape {x.shape}; a minimum of 1 is required")
    if not np.isfinite(x).all():
        raise ValueError("input contains NaN or infinity")
    return x


def row_norms(x: np.ndarray, squared: bool = False) -> np.ndarray:
    norms = np.einsum("ij,ij->i", x, x)
    return norms if squared else np.sqrt(norms)


def _upcast_batch(n_x: int, n_y: int, n_features: int) -> int:
    """Rows per block of the float32 path: at most ~10 % more memory than
    X, Y and the result take, and at least 10 MiB."""
    maxmem = max(((n_x + n_y) * n_features + n_x * n_y) / 10, 10 * 2 ** 17)
    tmp = 2 * n_features
    return max(int((-tmp + math.sqrt(tmp ** 2 + 4 * maxmem)) / 2), 1)


def euclidean_distances(x: np.ndarray, y: Optional[np.ndarray] = None,
                        squared: bool = False) -> np.ndarray:
    """(N, D), (M, D) -> (N, M) euclidean distances; ``y`` None is ``x``
    against itself."""
    same = y is None or y is x
    y = x if same else y
    if x.dtype == np.float32 or y.dtype == np.float32:
        out = np.empty((len(x), len(y)), np.float32)
        bs = _upcast_batch(len(x), len(y), x.shape[1])
        for i0 in range(0, len(x), bs):
            xc = x[i0:i0 + bs].astype(np.float64)
            xx = row_norms(xc, squared=True)[:, None]
            for j0 in range(0, len(y), bs):
                if same and j0 < i0:
                    d = out[j0:j0 + bs, i0:i0 + bs].T
                else:
                    yc = y[j0:j0 + bs].astype(np.float64)
                    d = -2 * (xc @ yc.T)
                    d += xx
                    d += row_norms(yc, squared=True)[None, :]
                out[i0:i0 + bs, j0:j0 + bs] = d.astype(np.float32, copy=False)
    else:
        xx = row_norms(x, squared=True)[:, None]
        yy = xx.T if same else row_norms(y, squared=True)[None, :]
        out = -2 * (x @ y.T)
        out += xx
        out += yy
    np.maximum(out, 0, out=out)
    if same:
        np.fill_diagonal(out, 0)
    return out if squared else np.sqrt(out, out=out)


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """scikit-learn's normalize(x): rows over their L2 norms, a zero row
    divided by 1."""
    norms = row_norms(x)
    norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
    return x / norms[:, None]


def cosine_distances(x: np.ndarray, y: Optional[np.ndarray] = None) -> np.ndarray:
    same = y is None or y is x
    xn = normalize_rows(x)
    s = xn @ (xn if same else normalize_rows(y)).T
    s *= -1
    s += 1
    s = np.clip(s, 0.0, 2.0)
    if same:
        np.fill_diagonal(s, 0.0)
    return s


def pairwise_distances(x: np.ndarray, y: Optional[np.ndarray] = None,
                       metric: str = "euclidean") -> np.ndarray:
    """scikit-learn's pairwise_distances for l1/manhattan, l2/euclidean and
    cosine."""
    kind = METRIC_ALIASES.get(metric)
    if kind is None:
        raise ValueError(f"unknown metric {metric!r}")
    x = as_float_array(x)
    if y is not None and y is not x:
        y = as_float_array(y)
        if x.dtype != y.dtype:
            x, y = x.astype(np.float64), y.astype(np.float64)
    if kind == "euclidean":
        return euclidean_distances(x, y)
    if kind == "cosine":
        return cosine_distances(x, y)
    x = x.astype(np.float64, copy=False)  # scipy's cdist computes in float64
    return cdist(x, x if y is None else y.astype(np.float64, copy=False), "cityblock")


def encode_labels(labels) -> tuple:
    """(labels as 0..L-1 in sorted order of the originals, the originals)."""
    classes, enc = np.unique(np.asarray(labels), return_inverse=True)
    return enc.reshape(-1), classes


def _check_n_labels(n_labels: int, n_samples: int) -> None:
    if not 1 < n_labels < n_samples:
        raise ValueError(f"Number of labels is {n_labels}. Valid values are 2 to "
                         "n_samples - 1 (inclusive)")


def silhouette_samples(x, labels, metric: str = "euclidean",
                       distances: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-sample silhouettes; ``distances`` (optional) is
    ``pairwise_distances(x, metric=metric)``, computed beforehand."""
    x = check_finite(as_float_array(x))
    labels, classes = encode_labels(labels)
    if len(labels) != len(x):
        raise ValueError("x and labels have different lengths")
    n = len(labels)
    freqs = np.bincount(labels)
    _check_n_labels(len(classes), n)
    rows = n if distances is not None else max(1, min(n, SILHOUETTE_BLOCK_ELEMENTS // n))
    intra, inter = [], []
    for r0 in range(0, n, rows):
        if distances is not None:
            d = distances
        else:
            d = pairwise_distances(x if rows >= n else x[r0:r0 + rows], x, metric)
            if METRIC_ALIASES[metric] == "euclidean":
                d.flat[r0::n + 1] = 0  # the block's entries on the diagonal
        # each row's sums per label, in column order and in float64 (one
        # bincount over the block, as scikit-learn's one per row), then
        # rounded to the distances' dtype
        nl = len(freqs)
        bins = (np.arange(len(d))[:, None] * nl + labels[None, :]).ravel()
        per = np.bincount(bins, weights=d.ravel(), minlength=len(d) * nl).reshape(len(d), nl)
        per = per.astype(d.dtype, copy=False)
        idx = (np.arange(len(d)), labels[r0:r0 + len(d)])
        intra.append(per[idx])
        per[idx] = np.inf
        per /= freqs
        inter.append(per.min(axis=1))
    intra, inter = np.concatenate(intra), np.concatenate(inter)
    denom = (freqs - 1).take(labels, mode="clip")
    with np.errstate(divide="ignore", invalid="ignore"):
        intra /= denom
        sil = inter - intra
        sil /= np.maximum(intra, inter)
    return np.nan_to_num(sil)


def silhouette_score(x, labels, metric: str = "euclidean") -> float:
    return float(np.mean(silhouette_samples(x, labels, metric=metric)))


def calinski_harabasz_score(x, labels) -> float:
    x = check_finite(as_float_array(x)).astype(np.float64, copy=False)
    labels, classes = encode_labels(labels)
    n = len(x)
    k = len(classes)
    _check_n_labels(k, n)
    extra, intra = 0.0, 0.0
    mean = np.mean(x, axis=0)
    for c in range(k):
        xc = x[labels == c]
        mc = np.mean(xc, axis=0)
        extra += xc.shape[0] * np.sum((mc - mean) ** 2)
        intra += np.sum((xc - mc) ** 2)
    return float(1.0 if intra == 0.0 else extra * (n - k) / (intra * (k - 1.0)))
