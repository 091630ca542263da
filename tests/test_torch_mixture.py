"""The port's Gaussian mixtures (ood/mixture.py, NumPy and SciPy) against
scikit-learn 1.9's GaussianMixture and BayesianGaussianMixture, at the
defaults the JAX package's cluster search uses (full covariances, k-means
initialisation, no random_state).

Both sides start from the same ``np.random.seed`` and draw their k-means++
initialisations from NumPy's global RandomState, grid point after grid
point as the search does. Labels must be equal and so must the fits that
fail (the float32 Cholesky factorisations that break), and the global state
after the whole grid. The parameters of the fits that succeed agree within
1e-4 relative (weights, means) and 1e-3 of the largest entry (covariances)."""

import warnings

import numpy as np
import pytest

from ood_in_object_detection_torch.ood import mixture as tmx
from torch_threads import _two_threads  # noqa: F401 (autouse)

KS = range(2, 15)  # RANGE_OF_CLUSTERS
PAIRS = {"GMM": ("GaussianMixture", tmx.GaussianMixture),
         "BGMM": ("BayesianGaussianMixture", tmx.BayesianGaussianMixture)}


@pytest.fixture(autouse=True)
def _quiet():
    """No warnings, and one BLAS / OpenMP thread (tier-1's six workers
    share the host's cores)."""
    from threadpoolctl import threadpool_limits

    with warnings.catch_warnings(), threadpool_limits(limits=1):
        warnings.simplefilter("ignore")
        yield


def blobs(seed, n, d, k, spread, dtype=np.float32, normalize=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, d))[rng.integers(0, k, n)] + spread * rng.normal(size=(n, d))
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(dtype)


def _grid(cls, x, seed=0):
    """fit_predict at every k after ``np.random.seed(seed)`` -> (labels or
    'ValueError' per k, the fitted estimators, the global state's key)."""
    np.random.seed(seed)
    out, fitted = [], []
    for k in KS:
        est = cls(n_components=k)
        try:
            out.append(np.asarray(est.fit_predict(x)))
            fitted.append(est)
        except ValueError:
            out.append("ValueError")
            fitted.append(None)
    return out, fitted, np.random.get_state()[1].copy()


def _both(name, x, seed=0):
    from sklearn import mixture

    sk_cls = getattr(mixture, PAIRS[name][0])
    return _grid(PAIRS[name][1], x, seed), _grid(sk_cls, x, seed)


def _assert_grid_equal(got, want):
    for k, g, w in zip(KS, got[0], want[0]):
        if isinstance(w, str) or isinstance(g, str):
            assert g == w, f"k {k}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"k {k}")
    np.testing.assert_array_equal(got[2], want[2], err_msg="global RandomState after the grid")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,d", [(60, 2), (120, 6), (200, 32)])
@pytest.mark.parametrize("name", list(PAIRS))
def test_labels_match_sklearn(name, n, d, dtype):
    """k 2..14 in a row from one seed: the same labels, the same failures,
    the same global RandomState afterwards."""
    x = blobs(n + d, n, d, 4, 0.4, dtype=dtype, normalize=d > 2)
    got, want = _both(name, x)
    _assert_grid_equal(got, want)
    assert sum(not isinstance(w, str) for w in want[0]) > 0, "every fit failed"
    assert max(len(set(w.tolist())) for w in want[0] if not isinstance(w, str)) > 1


@pytest.mark.parametrize("name", list(PAIRS))
def test_fitted_parameters_match_sklearn(name):
    """Weights, means (1e-4 relative) and covariances (1e-3 of the largest
    entry) of every fit that succeeds; iteration counts and convergence
    equal."""
    x = blobs(3, 150, 6, 3, 0.5, dtype=np.float64, normalize=False)
    (_, tfit, _), (_, sfit, _) = _both(name, x, seed=4)
    checked = 0
    for t, s in zip(tfit, sfit):
        assert (t is None) == (s is None)
        if s is None:
            continue
        np.testing.assert_allclose(t.weights_, s.weights_, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(t.means_, s.means_, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(t.covariances_, s.covariances_, rtol=0,
                                   atol=1e-3 * np.abs(s.covariances_).max())
        assert (t.n_iter_, t.converged_) == (s.n_iter_, s.converged_)
        checked += 1
    assert checked > 5


@pytest.mark.parametrize("name", list(PAIRS))
def test_wide_float32_fails_where_sklearn_fails(name):
    """N 60 at D 512 in float32 (the paper's widths, fewer samples than
    features): scikit-learn's Cholesky factorisations fail at every k, and
    the port's fail at the same k after the same k-means draws."""
    x = blobs(1, 60, 512, 3, 3.0, normalize=False)
    got, want = _both(name, x)
    assert want[0] == ["ValueError"] * len(KS)
    _assert_grid_equal(got, want)


@pytest.mark.parametrize("name", list(PAIRS))
def test_k_above_n_raises_before_any_draw(name):
    """n_samples < n_components raises ValueError and leaves the global
    RandomState as it was, in both."""
    from sklearn import mixture

    x = blobs(2, 5, 3, 2, 0.3)
    for cls in (PAIRS[name][1], getattr(mixture, PAIRS[name][0])):
        np.random.seed(7)
        before = np.random.get_state()[1].copy()
        with pytest.raises(ValueError, match="n_samples >= n_components"):
            cls(n_components=6).fit_predict(x)
        np.testing.assert_array_equal(np.random.get_state()[1], before)


def test_logsumexp_matches_sklearn():
    """scikit-learn's own logsumexp, -inf rows and ties of the maximum
    included, in both dtypes."""
    from sklearn.utils._array_api import _logsumexp

    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        a = rng.normal(size=(40, 7)).astype(dtype) * 30
        a[3] = -np.inf
        a[5, :3] = a[5].max()
        np.testing.assert_array_equal(tmx.logsumexp(a, axis=1), _logsumexp(a, axis=1))
