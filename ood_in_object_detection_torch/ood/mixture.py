"""Gaussian mixtures with scikit-learn 1.9's defaults, in NumPy and SciPy.

Counterparts: scikit-learn's ``mixture/_gaussian_mixture.py``
``GaussianMixture(n_components)`` and ``mixture/_bayesian_mixture.py``
``BayesianGaussianMixture(n_components)``, as
ood_in_object_detection_tpu/ood/clustering.py (``GMM``, ``BGMM``) calls them:
full covariances, ``reg_covar`` 1e-6, ``tol`` 1e-3, ``max_iter`` 100, one
initialisation from k-means labels, and for BGMM the Dirichlet-process
prior with scikit-learn's default priors (concentration 1/k, mean precision
1, mean the data's mean, D degrees of freedom, covariance ``np.cov(X.T)``).

The same data and the same random state give scikit-learn's labels, and the
same failures, because every step is scikit-learn's own arithmetic in its
order and dtype:

- float32 input stays float32 (BGMM's covariances are float64, as there);
- the k-means initialisation is ``ood/kmeans.py:KMeans`` drawing from the
  same ``RandomState``: ``random_state=None`` is NumPy's global one, so a
  fit takes its k-means++ draws from ``np.random`` as scikit-learn's does;
- ``n_samples < n_components`` raises ValueError before any draw;
- the Cholesky factors and their inverses come from
  ``scipy.linalg.cholesky`` / ``solve_triangular``; a factorisation that
  fails raises scikit-learn's ValueError ("ill-defined empirical
  covariance"), after the k-means draws;
- ``fit_predict`` ends with a final E-step on the last parameters and
  returns its arg-max.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg
from scipy.special import betaln, digamma, gammaln

from .kmeans import KMeans

ILL_DEFINED = ("Fitting the mixture model failed because some components have ill-defined "
               "empirical covariance (for instance caused by singleton or collapsed samples). "
               "Try to decrease the number of components, increase reg_covar, or scale the "
               "input data.")


def _check_input(x) -> np.ndarray:
    """scikit-learn's ``validate_data(X, dtype=[float64, float32],
    ensure_min_samples=2)``."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {x.shape}")
    if x.shape[0] < 2 or x.shape[1] < 1:
        raise ValueError(f"found array with shape {x.shape}; a minimum of 2 samples and "
                         "1 feature is required")
    if not np.isfinite(x).all():
        raise ValueError("input contains NaN or infinity")
    return x


def _random_state(rs) -> np.random.RandomState:
    if rs is None:
        return np.random.mtrand._rand
    if isinstance(rs, np.random.RandomState):
        return rs
    return np.random.RandomState(rs)


def logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    """scikit-learn's ``utils._array_api._logsumexp`` (not SciPy's): the
    maxima's count is taken out of the sum and added back as log(m)."""
    a_max = np.max(a, axis=axis, keepdims=True)
    at_max = a == a_max
    a = a.copy()
    a[at_max] = -np.inf
    m = np.sum(at_max.astype(a.dtype), axis=axis, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    e = np.exp(a - shift)
    s = np.sum(e, axis=axis, keepdims=True, dtype=e.dtype)
    s = np.where(s == 0, s, s / m)
    out = np.log1p(s) + np.log(m) + a_max
    return np.squeeze(out, axis=axis)


def gaussian_parameters(x: np.ndarray, resp: np.ndarray, reg_covar: float):
    """(nk, means, full covariances) of responsibilities ``resp``."""
    nk = np.sum(resp, axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, np.newaxis]
    k, d = means.shape
    cov = np.empty((k, d, d), dtype=x.dtype)
    reg = np.asarray(reg_covar, dtype=x.dtype)
    for j in range(k):
        diff = x - means[j, :]
        cov[j, :, :] = ((resp[:, j] * diff.T) @ diff) / nk[j]
        cov[j, :, :].flat[:d * d:d + 1] += reg
    return nk, means, cov


def precision_cholesky(cov: np.ndarray) -> np.ndarray:
    """The upper Cholesky factors of the precisions: inv(chol(cov)).T."""
    k, d, _ = cov.shape
    out = np.empty((k, d, d), dtype=cov.dtype)
    for j in range(k):
        try:
            chol = scipy.linalg.cholesky(cov[j, :, :], lower=True)
        except np.linalg.LinAlgError:
            msg = ILL_DEFINED
            if cov.dtype == np.float32:
                msg += (" The numerical accuracy can also be improved by passing float64"
                        " data instead of float32.")
            raise ValueError(msg) from None
        out[j, :, :] = scipy.linalg.solve_triangular(
            chol, np.eye(d, dtype=cov.dtype), lower=True).T
    return out


def log_det_cholesky(prec_chol: np.ndarray) -> np.ndarray:
    k, d, _ = prec_chol.shape
    return np.sum(np.log(np.reshape(prec_chol, (k, -1))[:, ::d + 1]), axis=1)


def log_gaussian_prob(x: np.ndarray, means: np.ndarray, prec_chol: np.ndarray) -> np.ndarray:
    n, d = x.shape
    log_det = log_det_cholesky(prec_chol)
    log_prob = np.empty((n, len(means)), dtype=x.dtype)
    for j in range(len(means)):
        y = (x @ prec_chol[j, :, :]) - (means[j, :] @ prec_chol[j, :, :])
        log_prob[:, j] = np.sum(np.square(y), axis=1)
    return -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det


class _Mixture:
    """scikit-learn's ``BaseMixture.fit_predict`` with ``n_init`` 1,
    ``init_params='kmeans'`` and no warm start."""

    def __init__(self, n_components: int = 1, tol: float = 1e-3, reg_covar: float = 1e-6,
                 max_iter: int = 100, random_state=None):
        self.n_components, self.tol, self.reg_covar = n_components, tol, reg_covar
        self.max_iter, self.random_state = max_iter, random_state

    def fit_predict(self, x) -> np.ndarray:
        x = _check_input(x)
        k = self.n_components
        if not isinstance(k, (int, np.integer)) or k < 1:
            raise ValueError(f"n_components must be an int >= 1, got {k!r}")
        if x.shape[0] < k:
            raise ValueError("Expected n_samples >= n_components but got "
                             f"n_components = {k}, n_samples = {x.shape[0]}")
        self._check_parameters(x)
        rng = _random_state(self.random_state)
        resp = np.zeros((x.shape[0], k), dtype=x.dtype)
        label = KMeans(n_clusters=k, random_state=rng).fit(x).labels_
        resp[np.arange(x.shape[0]), label] = 1
        self._initialize(x, resp)
        lower_bound = -np.inf
        self.converged_ = False
        for n_iter in range(1, self.max_iter + 1):
            prev = lower_bound
            log_prob_norm, log_resp = self._e_step(x)
            self._m_step(x, log_resp)
            lower_bound = self._lower_bound(log_resp, log_prob_norm)
            if abs(lower_bound - prev) < self.tol:
                self.converged_ = True
                break
        self.n_iter_, self.lower_bound_ = n_iter, lower_bound
        self._finish()
        return np.argmax(self._e_step(x)[1], axis=1)

    def _e_step(self, x):
        weighted = self._log_prob(x) + self._log_weights()
        log_prob_norm = logsumexp(weighted, axis=1)
        with np.errstate(under="ignore"):
            log_resp = weighted - log_prob_norm[:, np.newaxis]
        return np.mean(log_prob_norm), log_resp

    def _finish(self):
        pass


class GaussianMixture(_Mixture):
    """``fit_predict`` -> labels; ``weights_``, ``means_``, ``covariances_``,
    ``precisions_cholesky_``, ``n_iter_``, ``converged_``, ``lower_bound_``."""

    def _check_parameters(self, x):
        pass

    def _initialize(self, x, resp):
        weights, self.means_, self.covariances_ = gaussian_parameters(x, resp, self.reg_covar)
        weights /= x.shape[0]
        self.weights_ = weights
        self.precisions_cholesky_ = precision_cholesky(self.covariances_)

    def _m_step(self, x, log_resp):
        self.weights_, self.means_, self.covariances_ = gaussian_parameters(
            x, np.exp(log_resp), self.reg_covar)
        self.weights_ /= np.sum(self.weights_)
        self.precisions_cholesky_ = precision_cholesky(self.covariances_)

    def _log_prob(self, x):
        return log_gaussian_prob(x, self.means_, self.precisions_cholesky_)

    def _log_weights(self):
        return np.log(self.weights_)

    def _lower_bound(self, log_resp, log_prob_norm):
        return log_prob_norm


class BayesianGaussianMixture(_Mixture):
    """Variational mixture under the Dirichlet-process prior; ``weights_``
    (from the stick-breaking concentrations), ``means_``, ``covariances_``,
    ``precisions_cholesky_``, ``degrees_of_freedom_``, ``mean_precision_``,
    ``weight_concentration_``."""

    def _check_parameters(self, x):
        self.weight_concentration_prior_ = 1.0 / self.n_components
        self.mean_precision_prior_ = 1.0
        self.mean_prior_ = x.mean(axis=0)
        self.degrees_of_freedom_prior_ = x.shape[1]
        self.covariance_prior_ = np.atleast_2d(np.cov(x.T))

    def _initialize(self, x, resp):
        self._update(*gaussian_parameters(x, resp, self.reg_covar))

    def _m_step(self, x, log_resp):
        self._update(*gaussian_parameters(x, np.exp(log_resp), self.reg_covar))

    def _update(self, nk, xk, sk):
        # weights: the stick-breaking Beta parameters
        self.weight_concentration_ = (
            1.0 + nk,
            self.weight_concentration_prior_ + np.hstack((np.cumsum(nk[::-1])[-2::-1], 0)))
        # means
        self.mean_precision_ = self.mean_precision_prior_ + nk
        self.means_ = (self.mean_precision_prior_ * self.mean_prior_
                       + nk[:, np.newaxis] * xk) / self.mean_precision_[:, np.newaxis]
        # precisions: full Wishart, normalised by the degrees of freedom
        k, d = xk.shape
        self.degrees_of_freedom_ = self.degrees_of_freedom_prior_ + nk
        self.covariances_ = np.empty((k, d, d))
        for j in range(k):
            diff = xk[j] - self.mean_prior_
            self.covariances_[j] = (self.covariance_prior_ + nk[j] * sk[j]
                                    + nk[j] * self.mean_precision_prior_
                                    / self.mean_precision_[j] * np.outer(diff, diff))
        self.covariances_ /= self.degrees_of_freedom_[:, np.newaxis, np.newaxis]
        self.precisions_cholesky_ = precision_cholesky(self.covariances_)

    def _log_weights(self):
        a, b = self.weight_concentration_
        digamma_sum = digamma(a + b)
        digamma_b = digamma(b)
        return (digamma(a) - digamma_sum
                + np.hstack((0, np.cumsum(digamma_b - digamma_sum)[:-1])))

    def _log_prob(self, x):
        d = x.shape[1]
        dof = self.degrees_of_freedom_
        log_gauss = (log_gaussian_prob(x, self.means_, self.precisions_cholesky_)
                     - 0.5 * d * np.log(dof))
        log_lambda = d * np.log(2.0) + np.sum(
            digamma(0.5 * (dof - np.arange(0, d)[:, np.newaxis])), 0)
        return log_gauss + 0.5 * (log_lambda - d / self.mean_precision_)

    def _lower_bound(self, log_resp, log_prob_norm):
        d = self.mean_prior_.shape[0]
        dof = self.degrees_of_freedom_
        log_det = log_det_cholesky(self.precisions_cholesky_) - 0.5 * d * np.log(dof)
        log_wishart = np.sum(-(dof * log_det + dof * d * 0.5 * math.log(2.0)
                               + np.sum(gammaln(0.5 * (dof - np.arange(d)[:, np.newaxis])), 0)))
        log_norm_weight = -np.sum(betaln(*self.weight_concentration_))
        return (-np.sum(np.exp(log_resp) * log_resp) - log_wishart - log_norm_weight
                - 0.5 * d * np.sum(np.log(self.mean_precision_)))

    def _finish(self):
        a, b = self.weight_concentration_
        total = a + b
        self.weights_ = a / total * np.hstack((1, np.cumprod((b / total)[:-1])))
        self.weights_ /= np.sum(self.weights_)
