"""The port's mean shift (ood/meanshift.py, NumPy) against scikit-learn
1.9's ``MeanShift(bandwidth=None, cluster_all=...)`` and
``estimate_bandwidth``, as the JAX package's cluster search calls them.

Labels equal, numbering included (the centres' order follows from them);
the bandwidth within 1e-7 relative (scikit-learn's neighbour search takes
float32 distances through its own blocks); centres within 1e-5 (a window's
mean is added in float64 here, in the data's dtype there) and the climbs'
largest step count equal."""

import warnings

import numpy as np
import pytest

from ood_in_object_detection_torch.ood import meanshift as tms
from torch_threads import _two_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _quiet():
    from threadpoolctl import threadpool_limits

    with warnings.catch_warnings(), threadpool_limits(limits=1):
        warnings.simplefilter("ignore")
        yield


def blobs(seed, n, d, k, spread, dtype=np.float32, normalize=True, outliers=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, d))[rng.integers(0, k, n)] + spread * rng.normal(size=(n, d))
    if outliers:
        x[rng.choice(n, outliers, replace=False)] = 6 * rng.normal(size=(outliers, d))
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


def _assert_same(x, cluster_all):
    from sklearn.cluster import MeanShift, estimate_bandwidth

    want = MeanShift(cluster_all=cluster_all).fit(x)
    got = tms.MeanShift(cluster_all=cluster_all).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.cluster_centers_.dtype == want.cluster_centers_.dtype
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.bandwidth_, estimate_bandwidth(x), rtol=1e-7)
    assert got.n_iter_ == want.n_iter_
    return want


# (N, D, blobs, spread, dtype, unit rows): small D takes scikit-learn's k-d
# tree, D above 15 its brute-force search; the paper's groups are unit rows
BLOBS = {"d2": (60, 2, 4, 0.5, np.float32, False),
         "d6_f64": (120, 6, 4, 0.7, np.float64, False),
         "d6_unit": (300, 6, 4, 0.5, np.float32, True),
         "d32_f64": (200, 32, 4, 1.0, np.float64, False),
         "d256_unit": (150, 256, 3, 0.3, np.float32, True)}


@pytest.mark.parametrize("cluster_all", [True, False])
@pytest.mark.parametrize("case", list(BLOBS))
def test_meanshift_matches_sklearn(case, cluster_all):
    """Blobs with outliers: with cluster_all False they are orphans (-1)."""
    n, d, k, spread, dtype, unit = BLOBS[case]
    want = _assert_same(blobs(n + d, n, d, k, spread, dtype, unit, outliers=5), cluster_all)
    assert len(want.cluster_centers_) > 1, "one centre: the case checks little"
    if not cluster_all and d < 15:  # outliers beyond every window
        assert (want.labels_ == -1).any()


TIES = {
    # two pairs of equal size: the intensities tie and the centres' own
    # coordinates order them, descending
    "tied_pairs": np.array([[0, 0], [0, 1], [10, 0], [10, 1], [5, 50], [5, 51]], np.float32),
    "tied_triples": np.array([[0, 0], [0.5, 0], [0, 0.5], [10, 0], [10.5, 0], [10, 0.5]]),
    "duplicates": np.repeat(np.random.default_rng(0).normal(size=(4, 3)), 5, axis=0),
    "all_equal": np.ones((30, 8), np.float32),  # bandwidth 0
    "one_sample": np.ones((1, 4), np.float32),
}


@pytest.mark.parametrize("case", list(TIES))
def test_meanshift_ties_and_degenerate_inputs_match_sklearn(case):
    for cluster_all in (True, False):
        _assert_same(TIES[case], cluster_all)


def test_bandwidth_counts_the_sample_itself():
    """estimate_bandwidth on 10 points of a line: int(0.3 * 10) = 3
    neighbours, the sample itself the first, so each row's distance is that
    of its second-nearest other point."""
    from sklearn.cluster import estimate_bandwidth

    x = np.arange(10, dtype=np.float64)[:, None] ** 2
    np.testing.assert_allclose(tms.estimate_bandwidth(x), estimate_bandwidth(x), rtol=1e-12)
    d = np.abs(x - x.T)
    np.testing.assert_allclose(tms.estimate_bandwidth(x), np.sort(d, axis=1)[:, 2].mean())
