"""The port's cluster search (ood/clustering.py and the clusterers, k-means
and scores under it, none of which uses scikit-learn) against the JAX
package's ood/clustering.py, which runs scikit-learn, and against
scikit-learn itself, on seeded blobs. Model-free.

Labels must be equal, numbering included (the centroids' order and the
chosen grid point follow from them); scores agree within 1e-6 relative;
k-means centres within 1e-5."""

import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ood_in_object_detection_tpu import constants as JC
from ood_in_object_detection_tpu.core.config import ClustersParams as JParams
from ood_in_object_detection_tpu.ood import clustering as jcl
from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_torch.core.config import CUSTOM_HYP
from ood_in_object_detection_torch.core.config import ClustersParams as TParams
from ood_in_object_detection_torch.ood import cluster_metrics as tcm
from ood_in_object_detection_torch.ood import clusterers as tcs
from ood_in_object_detection_torch.ood import clustering as tcl
from ood_in_object_detection_torch.ood import hdbscan as thd
from ood_in_object_detection_torch.ood import kmeans as tkm
from ood_in_object_detection_torch.ood import methods as tmethods
from torch_threads import _two_threads  # noqa: F401 (autouse)

GRID = [m for m in JC.BENCHMARKS["cluster_methods"] if m != "one"]
METRICS = ["l1", "l2", "cosine"]
# (N, D, blobs, spread) per seed: the paper's groups are unit rows of
# 256-512 channels; the small D takes scikit-learn's tree paths
SIZES = {0: (24, 8, 2, 0.3), 1: (90, 32, 3, 0.6), 2: (200, 256, 4, 1.0)}
OPTIONS = {"remove_orphans": dict(REMOVE_ORPHANS=True),
           "orphans_own_cluster": dict(MAKE_EACH_ORPHAN_EACH_OWN_CLUSTER=True),
           "density_metric": dict(USE_DENSITY_BASED_METRIC=True),
           "remove_and_own": dict(REMOVE_ORPHANS=True, MAKE_EACH_ORPHAN_EACH_OWN_CLUSTER=True)}


@pytest.fixture(autouse=True)
def _quiet():
    """No warnings, and one BLAS / OpenMP thread: tier-1 runs six workers
    on the host's cores, and scikit-learn's OpenMP loops, oversubscribed,
    ran these small fits ~20x slower."""
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


def both_labels(x, method, metric, perf="silhouette", **opts):
    """(port labels or exception type, JAX labels or exception type)."""
    out = []
    for fit, params in ((tcl.fit_cluster_labels, TParams), (jcl.fit_cluster_labels, JParams)):
        try:
            out.append(np.asarray(fit(x, method, metric, perf, hyp=params(**opts))))
        except Exception as e:  # the same failure on both sides
            out.append(type(e).__name__)
    return out


def assert_same(got, want, where=""):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want, where
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("method", GRID)
def test_fit_cluster_labels_matches_jax(method, metric):
    """Every method of the sweep grid, every metric, three seeds with N 24-200
    and D 8-256: the port's labels are the JAX package's (scikit-learn's)."""
    n_found = []
    for seed, (n, d, k, spread) in SIZES.items():
        got, want = both_labels(blobs(seed, n, d, k, spread), method, metric)
        assert_same(got, want, f"seed {seed}")
        n_found.append(len(set(want.tolist())))
    assert max(n_found) > 1, "every seed gave one cluster: the case checks little"


@pytest.mark.parametrize("method", GRID)
def test_calinski_harabasz_at_400_matches_jax(method):
    """calinski_harabasz as the search's score, N 400 with D 12 (scikit-learn's
    k-d tree for DBSCAN and HDBSCAN), unnormalised float64 rows."""
    metric = METRICS[GRID.index(method) % 3]
    x = blobs(7, 400, 12, 5, 0.5, dtype=np.float64, normalize=False)
    got, want = both_labels(x, method, metric, "calinski_harabasz")
    assert_same(got, want)
    assert len(set(want.tolist())) > 1


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("method", ["DBSCAN", "HDBSCAN"])
def test_orphan_options_match_jax(method, option, metric):
    """REMOVE_ORPHANS, MAKE_EACH_ORPHAN_EACH_OWN_CLUSTER and
    USE_DENSITY_BASED_METRIC (DBCV) on blobs with outliers."""
    x = blobs(3, 70, 16, 3, 0.4, outliers=6)
    for perf in ("silhouette", "calinski_harabasz"):
        got, want = both_labels(x, method, metric, perf, **OPTIONS[option])
        assert_same(got, want, perf)


DEGENERATE = {
    "n_le_min_samples": lambda: blobs(0, 3, 8, 1, 0.3),
    "all_equal": lambda: np.ones((30, 8), np.float32),
    "n_clusters_gt_n": lambda: blobs(1, 6, 8, 2, 0.3),
    "all_invalid": lambda: blobs(2, 5, 16, 5, 2.0),
    "float64_unit_rows": lambda: blobs(4, 40, 8, 3, 0.2, dtype=np.float64),
}


@pytest.mark.parametrize("case", list(DEGENERATE))
def test_degenerate_inputs_match_jax(case):
    """Few samples, equal samples, more clusters than samples, every
    configuration invalid: the same labels, or the same exception, for every
    method, metric and score."""
    x = DEGENERATE[case]()
    for method in GRID:
        for metric in METRICS:
            for perf in ("silhouette", "calinski_harabasz"):
                got, want = both_labels(x, method, metric, perf)
                assert_same(got, want, f"{method} {metric} {perf}")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("perf", ["silhouette", "calinski_harabasz"])
def test_score_labels_matches_jax(perf, metric):
    """_score_labels on labellings with orphans under every option, density
    based or not: None together, scores within 1e-6 relative."""
    scored = 0
    for seed in range(3):
        x = blobs(seed, 120, 32, 4, 0.5)
        for k in (2, 4, 7):
            labels = np.random.default_rng(seed + k).integers(-1, k, len(x))
            for opts in [{}] + list(OPTIONS.values()):
                for density in (False, True):
                    want = jcl._score_labels(x, labels, perf, metric, density, JParams(**opts))
                    got = tcl._score_labels(x, labels, perf, metric, density, TParams(**opts))
                    assert (got is None) == (want is None)
                    if want is not None:
                        np.testing.assert_allclose(got, want, rtol=1e-6)
                        scored += 1
    assert scored > 20


@pytest.mark.parametrize("metric", ["l1", "manhattan", "l2", "euclidean", "cosine"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cluster_metrics_match_sklearn(metric, dtype):
    from sklearn.metrics import calinski_harabasz_score, pairwise_distances, silhouette_score

    x = blobs(5, 150, 64, 3, 0.7, dtype=dtype, normalize=False)
    labels = np.random.default_rng(1).integers(-1, 4, len(x))
    d = tcm.pairwise_distances(x, metric=metric)
    ref = pairwise_distances(x, metric=metric)
    assert d.dtype == ref.dtype
    np.testing.assert_allclose(d, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tcm.silhouette_score(x, labels, metric=metric),
                               silhouette_score(x, labels, metric=metric), rtol=1e-6)
    np.testing.assert_allclose(tcm.calinski_harabasz_score(x, labels),
                               calinski_harabasz_score(x, labels), rtol=1e-6)


def test_silhouette_in_blocks_matches_one_block(monkeypatch):
    """The silhouette of a group above the block size (several blocks of
    rows) equals the one-block score."""
    x = blobs(6, 97, 16, 3, 0.5)
    labels = np.random.default_rng(2).integers(0, 3, len(x))
    for metric in METRICS:
        whole = tcm.silhouette_score(x, labels, metric)
        monkeypatch.setattr(tcm, "SILHOUETTE_BLOCK_ELEMENTS", 97 * 10)
        np.testing.assert_allclose(tcm.silhouette_score(x, labels, metric), whole, rtol=1e-6)
        monkeypatch.undo()


def _kmeans_pair(x, k, seed):
    from sklearn.cluster import KMeans

    return (tkm.KMeans(n_clusters=k, random_state=seed).fit(x),
            KMeans(n_clusters=k, random_state=seed, n_init="auto").fit(x))


def _assert_kmeans_equal(got, want):
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, rtol=0, atol=1e-5)
    assert got.n_iter_ == want.n_iter_


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,d", [(30, 1), (300, 8), (600, 256)])
def test_kmeans_matches_sklearn(n, d, dtype):
    """Labels, centres (1e-5) and iteration counts of scikit-learn's KMeans,
    k 1-14; N 600 spans three assignment blocks."""
    x = blobs(n + d, n, d, 5, 0.8, dtype=dtype, normalize=False)
    for k in (1, 2, 3, 5, 10, 14):
        _assert_kmeans_equal(*_kmeans_pair(x, k, 10))


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), k=st.integers(1, 9), n=st.integers(10, 120),
       d=st.sampled_from([1, 3, 16]))
def test_kmeans_property_matches_sklearn(seed, k, n, d):
    """Any seed of the k-means++ draw: scikit-learn's result."""
    x = blobs(seed % 1000, n, d, 4, 1.0, normalize=False)
    if k > n:
        with pytest.raises(ValueError):
            tkm.KMeans(n_clusters=k, random_state=seed).fit(x)
        return
    _assert_kmeans_equal(*_kmeans_pair(x, k, seed))


def test_kmeans_empty_cluster_relocation_matches_sklearn():
    """Duplicated samples leave clusters empty: the farthest samples move in."""
    x = np.repeat(blobs(9, 6, 4, 2, 0.5, normalize=False), 5, axis=0)
    for k in (4, 6, 8):
        _assert_kmeans_equal(*_kmeans_pair(x, k, 3))


@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "cosine"])
def test_clusterers_match_sklearn(metric):
    """Each clusterer against scikit-learn's estimator over its parameter,
    float32 unit rows and float64 raw rows with outliers."""
    from sklearn import cluster as skc

    for x in (blobs(11, 120, 24, 4, 0.5, outliers=5),
              blobs(12, 80, 6, 3, 0.4, dtype=np.float64, normalize=False, outliers=4)):
        for eps in (0.05, 0.2, 0.5, 1.5):
            for ms in (2, 3, 6):
                np.testing.assert_array_equal(
                    tcs.DBSCAN(eps=eps, min_samples=ms, metric=metric).fit_predict(x),
                    skc.DBSCAN(eps=eps, min_samples=ms, metric=metric).fit_predict(x))
        for mcs in (2, 3, 5, 9, 20):
            np.testing.assert_array_equal(
                thd.HDBSCAN(min_cluster_size=mcs, metric=metric).fit_predict(x),
                skc.HDBSCAN(min_cluster_size=mcs, metric=metric, copy=True).fit_predict(x))
        for k in (1, 2, 5, 14):
            np.testing.assert_array_equal(
                tcs.AgglomerativeClustering(n_clusters=k, metric=metric).fit_predict(x),
                skc.AgglomerativeClustering(n_clusters=k, metric=metric,
                                            linkage="complete").fit_predict(x))
        if metric == "euclidean":
            for thr in (0.05, 0.3, 0.8, 2.0):
                np.testing.assert_array_equal(
                    tcs.Birch(threshold=thr, branching_factor=50).fit_predict(x),
                    skc.Birch(threshold=thr, branching_factor=50,
                              n_clusters=None).fit_predict(x))


def test_birch_splits_match_sklearn():
    """A small branching factor and threshold split leaves and the root
    several times."""
    from sklearn.cluster import Birch

    for dtype in (np.float32, np.float64):
        x = blobs(13, 300, 8, 6, 0.8, dtype=dtype, normalize=False)
        for b in (3, 5, 50):
            np.testing.assert_array_equal(
                tcs.Birch(threshold=0.4, branching_factor=b).fit_predict(x),
                Birch(threshold=0.4, branching_factor=b, n_clusters=None).fit_predict(x))


@pytest.mark.parametrize("bad", [
    lambda: tkm.KMeans(n_clusters=5).fit(np.zeros((3, 2))),
    lambda: tcs.AgglomerativeClustering(n_clusters=5).fit_predict(np.ones((3, 2))),
    lambda: tcs.AgglomerativeClustering(n_clusters=1).fit_predict(np.ones((1, 2))),
    lambda: thd.HDBSCAN(min_cluster_size=5).fit_predict(np.ones((3, 2))),
    lambda: thd.HDBSCAN(min_cluster_size=2).fit_predict(np.ones((1, 2))),
    lambda: tcs.DBSCAN(eps=0.5).fit_predict(np.full((3, 2), np.nan)),
    lambda: tcm.silhouette_score(np.ones((4, 2)), [0, 0, 0, 0]),
])
def test_failures_raise_value_error(bad):
    """The configurations that make scikit-learn raise raise here too, so
    the search's catch-all scores the same ones as invalid."""
    with pytest.raises(ValueError):
        bad()


A7C_METHODS = ["MeanShift", "GMM", "BGMM"]


def _seeded(fit, *args, seed=0, **kw):
    """fit(*args) after np.random.seed(seed) -> (result or exception type,
    the global RandomState's key afterwards)."""
    np.random.seed(seed)
    try:
        out = np.asarray(fit(*args, **kw))
    except Exception as e:  # the same failure on both sides
        out = type(e).__name__
    return out, np.random.get_state()[1].copy()


@pytest.mark.parametrize("method", A7C_METHODS)
def test_unported_methods_raise(method):
    """MeanShift, GMM and BGMM, which no call refuses: fit_cluster_labels
    gives the JAX package's labels after the same global seed, and
    DistanceOODMethod.from_name builds the method, as in JAX."""
    x = blobs(0, 20, 4, 2, 0.3)
    got, got_state = _seeded(tcl.fit_cluster_labels, x, method, "l2")
    want, want_state = _seeded(jcl.fit_cluster_labels, x, method, "l2")
    assert_same(got, want)
    np.testing.assert_array_equal(got_state, want_state)
    m = tmethods.DistanceOODMethod.from_name("L2_cl_stride", cluster_method=method)
    assert m.cluster_method == jmethods.DistanceOODMethod.from_name(
        "L2_cl_stride", cluster_method=method).cluster_method == method


# (seed, N, D, blobs, spread, outliers) per method: two seeds' draws for the
# unseeded mixtures, blobs with outliers for MeanShift's orphans
A7C_DATA = {"MeanShift": [(20, 80, 6, 3, 0.3, 3), (21, 90, 24, 3, 0.3, 0)],
            "GMM": [(22, 60, 4, 3, 0.3, 0), (23, 80, 12, 4, 0.5, 4)],
            "BGMM": [(24, 60, 4, 3, 0.3, 0), (25, 80, 12, 4, 0.5, 4)]}


@pytest.mark.parametrize("remove_orphans", [False, True])
@pytest.mark.parametrize("perf", ["silhouette", "calinski_harabasz"])
@pytest.mark.parametrize("method", A7C_METHODS)
def test_a7c_fit_cluster_labels_matches_jax(method, perf, remove_orphans):
    """The three methods' searches (MeanShift's two padded configs, the
    mixtures' k 2..14 and the refit of the best) against the JAX package's
    after the same np.random.seed: the same labels and the same global
    RandomState afterwards, so the same draws in the same order."""
    found = []
    for seed, n, d, k, spread, outliers in A7C_DATA[method]:
        x = blobs(seed, n, d, k, spread, outliers=outliers)
        hyp = dict(REMOVE_ORPHANS=remove_orphans)
        got, got_state = _seeded(tcl.fit_cluster_labels, x, method, "l2", perf,
                                 hyp=TParams(**hyp), seed=seed)
        want, want_state = _seeded(jcl.fit_cluster_labels, x, method, "l2", perf,
                                   hyp=JParams(**hyp), seed=seed)
        assert_same(got, want, f"seed {seed}")
        np.testing.assert_array_equal(got_state, want_state, err_msg=f"seed {seed}")
        found.append(len(set(want.tolist())))
    assert max(found) > 1, "one cluster everywhere: the case checks little"


def test_score_curve_plot_raises(tmp_path, monkeypatch):
    """VISUALIZE plots a grid search's scores at the JAX package's file
    name, RESULTS_PATH/cluster_viz/{tag}_{method}_{perf_metric}_scores.png;
    'all', which searches nothing, plots nothing, as in JAX."""
    from ood_in_object_detection_torch import constants as TC

    monkeypatch.setattr(TC, "RESULTS_PATH", tmp_path / "torch")
    monkeypatch.setattr(JC, "RESULTS_PATH", tmp_path / "jax")
    x = blobs(0, 20, 4, 2, 0.3)
    for fit, params in ((tcl.fit_cluster_labels, TParams), (jcl.fit_cluster_labels, JParams)):
        fit(x, "KMeans", "l2", hyp=params(VISUALIZE=True), tag="L2_cl_stride_cls0_stride1")
        np.testing.assert_array_equal(fit(x, "all", "l2", hyp=params(VISUALIZE=True)),
                                      np.arange(20))
    names = [sorted(p.relative_to(tmp_path / k).as_posix()
                    for p in (tmp_path / k).rglob("*.png")) for k in ("torch", "jax")]
    assert names[0] == names[1] == [
        "cluster_viz/L2_cl_stride_cls0_stride1_KMeans_silhouette_scores.png"]


@pytest.mark.parametrize("method", A7C_METHODS + ["KMeans"])
def test_score_curve_inputs_match_jax(method, monkeypatch):
    """The plot's inputs, (scores, grid, method, perf_metric, tag), equal
    the JAX package's for each method and score (MeanShift's x axis is the
    config index: its two grid points carry bandwidth None)."""
    calls = {"torch": [], "jax": []}
    for key, mod in (("torch", tcl), ("jax", jcl)):
        monkeypatch.setattr(mod, "_plot_score_curve",
                            lambda *a, key=key: calls[key].append(a))
    x = blobs(26, 60, 6, 3, 0.4, outliers=3)
    for perf in ("silhouette", "calinski_harabasz"):
        for fit, params in ((tcl.fit_cluster_labels, TParams), (jcl.fit_cluster_labels, JParams)):
            _seeded(fit, x, method, "cosine", perf, hyp=params(VISUALIZE=True), tag="t")
    assert len(calls["torch"]) == len(calls["jax"]) == 2
    for (ts, tg, *trest), (js, jg, *jrest) in zip(calls["torch"], calls["jax"]):
        np.testing.assert_allclose(ts, js, rtol=1e-6)
        assert tg == jg and trest == jrest
    assert len(set(np.round(calls["jax"][0][0], 6))) > 1 or method == "MeanShift"


def test_score_curve_png(tmp_path, monkeypatch):
    """The curve is drawn with Pillow, without matplotlib (the card's
    machine has none), at the JAX file name and the JAX figure's 600 x 400
    pixels, and the canvas is not empty."""
    import sys

    from PIL import Image

    from ood_in_object_detection_torch import constants as TC

    monkeypatch.setattr(TC, "RESULTS_PATH", tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    grid = [{"n_components": k} for k in range(2, 15)]
    scores = list(np.linspace(-1, 0.5, 13))
    tcl._plot_score_curve(scores, grid, "GMM", "silhouette", "t")
    with Image.open(tmp_path / "cluster_viz" / "t_GMM_silhouette_scores.png") as img:
        assert img.size == (600, 400)
        px = np.asarray(img.convert("RGB"))
    assert (px != 255).any(axis=-1).sum() > 500, "an empty canvas"


@pytest.mark.parametrize("method", ["KMeans", "HDBSCAN"] + A7C_METHODS)
def test_candidate_grid_matches_jax(method):
    for remove_orphans in (False, True):
        jf, jgrid, jdens = jcl._candidate_grid(method, "l2", JParams(REMOVE_ORPHANS=remove_orphans))
        tf, tgrid, tdens = tcl._candidate_grid(method, "l2", TParams(REMOVE_ORPHANS=remove_orphans))
        assert tgrid == jgrid and tdens == jdens
        if method == "MeanShift":  # orphans stay -1 under REMOVE_ORPHANS
            assert tf(tgrid[0]).cluster_all == jf(jgrid[0]).cluster_all == (not remove_orphans)
    assert tcl.make_each_orphan_own_cluster(np.array([0, -1, 1, -1])).tolist() == \
        jcl.make_each_orphan_own_cluster(np.array([0, -1, 1, -1])).tolist()


def _fitted_pair(metric, ks, seed=0, d=12):
    """A JAX and a port distance method holding the same hand-made clusters:
    K per (class, stride) from ``ks`` (0 = no cluster), centroids means of
    unit rows (so not unit)."""
    rng = np.random.default_rng(seed)
    clusters = []
    for row in ks:
        out = []
        for k in row:
            if k == 0:
                out.append(np.empty(0))
                continue
            rows = rng.normal(size=(k, 4, d))
            rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
            out.append(rows.mean(axis=1).astype(np.float32))
        clusters.append(out)
    name = {"cosine": "Cosine_cl_stride", "l2": "L2_cl_stride", "l1": "L1_cl_stride"}[metric]
    jm = jmethods.DistanceOODMethod.from_name(name, cluster_method="KMeans")
    tm = tmethods.DistanceOODMethod.from_name(name, cluster_method="KMeans")
    jm.clusters, tm.clusters = clusters, clusters
    return jm, tm


@pytest.mark.parametrize("metric", METRICS)
def test_bank_and_distances_at_k_gt_1_match_jax(metric):
    """A multi-centroid bank (uneven K, empty groups, cosine centroids not
    unit before the renormalisation): the padded bank and every box's
    minimum distance equal the JAX package's."""
    ks = [[3, 0, 7], [1, 5, 0], [0, 0, 2], [14, 2, 1]]
    jm, tm = _fitted_pair(metric, ks)
    jb, tb = jm.bank(), tm.bank("cpu")
    np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
    np.testing.assert_allclose(tb.centroids.numpy(), np.asarray(jb.centroids), rtol=1e-6,
                               atol=1e-7)
    if metric == "cosine":
        norms = np.linalg.norm(tb.centroids.numpy(), axis=-1)[tb.count.numpy()[..., None] >
                                                               np.arange(14)]
        np.testing.assert_allclose(norms, 1.0, rtol=1e-6)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(50, 12)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    cls, lvl = rng.integers(0, 4, 50), rng.integers(0, 3, 50)
    import jax.numpy as jnp

    want = np.asarray(jm.distances(jnp.asarray(feats), jnp.asarray(cls), jnp.asarray(lvl)))
    got = tm.distances(torch.as_tensor(feats), torch.as_tensor(cls), torch.as_tensor(lvl))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (want == 1000.0).any() and (want < 1000.0).any()


@pytest.mark.parametrize("method", ["all", "KMeans", "DBSCAN", "Birch"])
def test_generate_clusters_on_blobs_match_jax(method):
    """generate_clusters over (class, stride) groups of raw activations,
    REMOVE_ORPHANS on: the centroids of each label in sorted order."""
    rng = np.random.default_rng(3)
    acts = [[rng.normal(size=(n, 16)).astype(np.float32) if n else np.empty(0)
             for n in row] for row in ((40, 0, 3), (25, 60, 12))]
    jm, tm = _fitted_pair("l2", [[0] * 3] * 2)
    jm.cluster_method = tm.cluster_method = method
    from ood_in_object_detection_tpu.core.config import CUSTOM_HYP as JHYP

    prior = (JHYP.clusters.REMOVE_ORPHANS, CUSTOM_HYP.clusters.REMOVE_ORPHANS)
    JHYP.clusters.REMOVE_ORPHANS = CUSTOM_HYP.clusters.REMOVE_ORPHANS = True
    try:
        want, got = jm.generate_clusters(acts), tm.generate_clusters(acts)
    finally:
        JHYP.clusters.REMOVE_ORPHANS, CUSTOM_HYP.clusters.REMOVE_ORPHANS = prior
    for jrow, trow in zip(want, got):
        for j, t in zip(jrow, trow):
            assert np.shape(j) == np.shape(t)
            if np.ndim(j) == 2:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,cluster_method", [
    ("fusion-L2_cl_stride-Cosine_cl_stride", "KMeans-DBSCAN"),
    ("fusion-MSP-L1_cl_stride-Cosine_cl_stride", "all-HDBSCAN"),
    ("fusion-Cosine_cl_stride-L2_cl_stride", "Birch")])
def test_fusion_members_take_their_cluster_methods_as_jax(name, cluster_method):
    """'-'-separated cluster methods go to the fusion's distance members in
    order, the last one repeated (JAX cli/factory.py:54-58)."""
    from ood_in_object_detection_torch.cli.factory import build_ood_method as tbuild
    from ood_in_object_detection_tpu.cli.factory import build_ood_method as jbuild

    def members(m):
        return [(x.name, getattr(x, "cluster_method", None)) for x in m.methods]

    assert members(tbuild(name, cluster_method)) == members(jbuild(name, cluster_method))
