"""The --benchmark sweeps and the cluster search of the port against the
JAX package, on the non-degenerate fixture of tests/test_torch_pipeline.py
(96 px, nc 2, shared weights): each clusterer of the sweep grid on the
fixture's InD activations, the cluster_methods, used_tpr and
unk_loc_enhancement sweeps through both CLIs, and the BENCHMARK_MODE
prediction cache. Split out of tests/test_torch_pipeline.py so that the
tier-1 workers, which take a file each, share the two halves."""

import numpy as np
import pytest

from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood import pipeline as tpipe
from test_torch_pipeline import (CONF_TEST, CONF_TRAIN, KNOWN, NAMES, _cli_args,  # noqa: F401
                                 cos_acts, fx)
from test_torch_unknown import _both_hyp
from torch_threads import _two_threads  # noqa: F401 (autouse)


CLUSTER_GRID = ["one", "all", "DBSCAN", "KMeans", "KMeans_3", "KMeans_5", "KMeans_10",
                "HDBSCAN", "AgglomerativeClustering", "Birch"]


@pytest.fixture
def one_thread():
    """One BLAS / OpenMP thread for the cluster searches: tier-1's six
    workers share the host's cores, and scikit-learn's OpenMP loops,
    oversubscribed, slow small fits ~20x."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("method", CLUSTER_GRID)
@pytest.mark.usefixtures("one_thread")
def test_generate_clusters_on_fixture_matches_jax(cos_acts, method):
    """Cosine_cl_stride's generate_clusters on the fixture's InD activations
    (the JAX package's, given to both, so that a label is decided by the
    clusterers alone): the same centroids (1e-6), count and order."""
    jm = jmethods.DistanceOODMethod.from_name("Cosine_cl_stride", cluster_method=method)
    tm = tmethods.DistanceOODMethod.from_name("Cosine_cl_stride", cluster_method=method)
    want, got = jm.generate_clusters(cos_acts[0]), tm.generate_clusters(cos_acts[0])
    sizes = []
    for jrow, trow in zip(want, got):
        for j, t in zip(jrow, trow):
            assert np.shape(t) == np.shape(j)
            if np.ndim(j) == 2:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
                sizes.append(len(j))
    assert sizes, "no group was fitted"
    if method not in ("one", "DBSCAN", "HDBSCAN"):
        assert max(sizes) > 1, "every group got one centroid: the case checks little"


@pytest.mark.parametrize("method", ["GMM", "BGMM", "MeanShift"])
@pytest.mark.usefixtures("one_thread")
def test_a7c_clusters_and_decisions_match_jax(fx, cos_acts, method):
    """L2_cl_stride with GMM, BGMM and MeanShift fitted on the fixture's InD
    activations (the JAX package's, given to both) after the same
    np.random.seed: the same centroids (1e-6) and thresholds (1e-5), and
    the same decisions on the OoD batches (K3's plain version here)."""
    from ood_in_object_detection_tpu.ood import pipeline as jpipe
    from test_torch_pipeline import _flat

    jm = jmethods.DistanceOODMethod.from_name("L2_cl_stride", cluster_method=method)
    tm = tmethods.DistanceOODMethod.from_name("L2_cl_stride", cluster_method=method)
    for pipe, m in ((jpipe, jm), (tpipe, tm)):
        np.random.seed(0)
        pipe.fit_ind_pipeline(m, {id(m): cos_acts[0]}, tpr=0.95)
    sizes = []
    for jrow, trow in zip(jm.clusters, tm.clusters):
        for j, t in zip(jrow, trow):
            assert np.shape(t) == np.shape(j)
            if np.ndim(j) == 2:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
                sizes.append(len(j))
    assert sizes, "no group was fitted"
    if method != "MeanShift":  # one mode a group at these widths
        assert max(sizes) > 1, "every group got one centroid: the case checks little"
    jt, tt = _flat(jm.thresholds), _flat(tm.thresholds)
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    neck = fx["tdet"].neck_channels()
    decided = []
    for batch in fx["batches"]["ood"]:
        # the JAX detector's outputs on both sides: the decision is the fit's
        out = fx["jdet"].predict(batch["images"], conf_thres=CONF_TEST)
        jdec = np.asarray(jpipe._decisions_for_method(jm, out, fx["jdet"].neck_channels()))
        tout = fx["tdet"].predict(batch["images"], conf_thres=CONF_TEST)
        tdec = tpipe._decisions_for_method(tm, tout, neck).numpy()
        np.testing.assert_array_equal(tdec, jdec)
        decided.append(tdec[tout.det.valid.numpy()])
    assert len(np.concatenate(decided)) > 10


@pytest.mark.usefixtures("one_thread")
def test_cli_bgmm_with_score_curves(fx, tmp_path, monkeypatch):
    """cli.ood_eval --cluster_method BGMM --visualize_clusters on the
    fixture: one row, and one score-curve PNG per grid search, named by
    each (class, stride) group's tag."""
    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP

    monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / "results")
    monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / "storage")
    monkeypatch.setattr(CUSTOM_HYP.clusters, "VISUALIZE", False)  # the CLI sets it
    monkeypatch.setattr(ood_eval, "load_detector", lambda args, default_nc=20: fx["tdet"])
    tags = []
    fit = tmethods.fit_cluster_labels
    monkeypatch.setattr(tmethods, "fit_cluster_labels",
                        lambda *a, fit=fit, **k: tags.append(k["tag"]) or fit(*a, **k))
    np.random.seed(0)
    rows = ood_eval.main(["--ood_method", "Cosine_cl_stride", "--cluster_method", "BGMM",
                          "--visualize_clusters", *_cli_args(fx)])
    assert len(rows) == 1 and rows[0]["Method"] == "Cosine_cl_stride"
    assert CUSTOM_HYP.clusters.VISUALIZE
    pngs = sorted(p.name for p in (tmp_path / "results" / "cluster_viz").glob("*.png"))
    assert tags and pngs == sorted(f"{t}_BGMM_silhouette_scores.png" for t in tags)


def _run_both_sweeps(fx, tmp_path, monkeypatch, argv, grids, seed_acts=True):
    """``--benchmark`` through the port's CLI and the JAX package's on the
    fixture, each with its own detector, storage, results and cache; the
    JAX CLI runs first and, with ``seed_acts``, its InD activations are
    given to the port (``--load_ind_activations``), so both fit the same
    features. -> (port rows, JAX rows, the port's forwards at conf_thr_test)."""
    from ood_in_object_detection_torch import constants as TC
    from ood_in_object_detection_torch.cli import benchmarks as tbench
    from ood_in_object_detection_torch.cli import ood_eval as tcli
    from ood_in_object_detection_tpu import constants as JC
    from ood_in_object_detection_tpu.cli import benchmarks as jbench
    from ood_in_object_detection_tpu.cli import ood_eval as jcli

    rows, forwards = {}, {"n": 0}
    base = _cli_args(fx, *argv)
    for key, C, cli, bench, det in (("jax", JC, jcli, jbench, fx["jdet"]),
                                    ("torch", TC, tcli, tbench, fx["tdet"])):
        for attr, sub in (("RESULTS_PATH", "results"), ("STORAGE_PATH", "storage"),
                          ("TEMPORAL_STORAGE_PATH", "temp")):
            monkeypatch.setattr(C, attr, tmp_path / key / sub)
        monkeypatch.setattr(C, "BENCHMARKS", {**C.BENCHMARKS, **grids})
        monkeypatch.setattr(cli, "load_detector", lambda args, default_nc=20, d=det: d)
        write = bench.append_results
        monkeypatch.setattr(bench, "append_results", lambda r, *a, write=write, key=key:
                            rows.setdefault(key, list(r)) and write(r, *a))
        args = list(base)
        if key == "jax":
            i = args.index("--device")
            args = args[:i] + args[i + 2:]
        else:
            predict = det.predict

            def counting(images, conf_thres, predict=predict, **kw):
                forwards["n"] += conf_thres == CONF_TEST
                return predict(images, conf_thres=conf_thres, **kw)

            monkeypatch.setattr(det, "predict", counting)
            if seed_acts:  # the JAX CLI's logits and/or distance activations
                targs = cli.build_parser().parse_args(args)
                srcs = sorted((tmp_path / "jax" / "storage").glob("*_activations.pkl"))
                assert srcs
                for src in srcs:
                    kind = "MSP" if src.name.startswith("logits") else "Cosine_cl_stride"
                    method = tbench.build_ood_method(kind, targs.cluster_method)
                    tcli.cache_paths(targs, method)["activations"].write_bytes(src.read_bytes())
                args.append("--load_ind_activations")
        cli.main(args)
    return rows["torch"], rows["jax"], forwards["n"]


def _assert_rows_equal(trows, jrows, n):
    """Integer and string columns equal, floats within 1e-6."""
    from ood_in_object_detection_torch import constants as TC
    from ood_in_object_detection_torch.eval.results_writer import dataset_result_columns

    assert len(trows) == len(jrows) == n
    cols = TC.COMMON_COLUMNS + dataset_result_columns("coco_ood")
    for t, j in zip(trows, jrows):
        for c in cols:
            if isinstance(j[c], float):
                np.testing.assert_allclose(t[c], j[c], rtol=1e-6, err_msg=c)
            else:
                assert t[c] == j[c], c


@pytest.mark.usefixtures("one_thread")
def test_cli_benchmark_cluster_methods_matches_jax(fx, tmp_path, monkeypatch):
    """--benchmark cluster_methods over the whole grid: one row per
    clusterer, each the JAX CLI's (the clusters' mean and spread of counts,
    the OWOD columns)."""
    trows, jrows, _ = _run_both_sweeps(fx, tmp_path, monkeypatch, [
        "--ood_method", "Cosine_cl_stride", "--benchmark", "cluster_methods"], {})
    _assert_rows_equal(trows, jrows, len(CLUSTER_GRID))
    assert [r["cluster_method"] for r in trows] == CLUSTER_GRID
    assert len({r["mean_n_clus"] for r in trows}) > 2, "the clusterers all fitted alike"


def _assert_sdr_rows(trows, jrows):
    """Rows of methods with an SDR member, whose embedders start from each
    package's own random init: the same keys, the same non-float common
    columns (method, strategy, thresholds' settings), every OWOD column
    finite in both."""
    from ood_in_object_detection_torch import constants as TC
    from ood_in_object_detection_torch.eval.results_writer import dataset_result_columns

    assert trows and len(trows) == len(jrows)
    for t, j in zip(trows, jrows):
        assert set(t) == set(j)
        for c in dataset_result_columns("coco_ood"):
            assert np.isfinite(t[c]) and np.isfinite(j[c]), c
        for c in TC.COMMON_COLUMNS:  # the fitted groups' counts do not depend on the init
            if isinstance(j[c], float):
                np.testing.assert_allclose(t[c], j[c], rtol=1e-6, err_msg=c)
            else:
                assert t[c] == j[c], c


# the best_methods grid cut to a distance method without an embedder and
# the paper's SDR method (tests/test_torch_sdr.py holds all four SDR
# methods against the JAX package; the card's smoke run sweeps the grid)
BEST_GRID = ["L2_cl_stride", "CosineIvis"]
# the fusion_strategies grid cut to its fusion without an SDR member and
# the one of two distance members, under every strategy
FUSION_GRID = [["fusion-MSP-Sigmoid", "fusion-CosineIvis-Cosine_cl_stride"],
               ["and", "or", "score"]]


@pytest.mark.usefixtures("one_thread")
def test_cli_benchmark_best_methods_matches_jax(fx, tmp_path, monkeypatch):
    """--benchmark best_methods (a full fit per method, on the JAX CLI's
    InD activations): L2_cl_stride's row equals the JAX CLI's; the SDR row
    is present, finite and keyed alike; the SDR embedders were fitted on
    the CPU, the detector's device."""
    from ood_in_object_detection_torch.ood import sdr as tsdr

    fits = []
    fit = tsdr.fit_triplet_embedder
    monkeypatch.setattr(tsdr, "fit_triplet_embedder",
                        lambda *a, **kw: fits.append(kw["device"]) or fit(*a, **kw))
    trows, jrows, _ = _run_both_sweeps(fx, tmp_path, monkeypatch, [
        "--ood_method", "MSP", "--benchmark", "best_methods"], {"best_methods": BEST_GRID})
    assert [r["Method"] for r in trows] == [r["Method"] for r in jrows] == BEST_GRID
    _assert_rows_equal(trows[:1], jrows[:1], 1)
    _assert_sdr_rows(trows[1:], jrows[1:])
    assert len(fits) >= 2 and {str(d) for d in fits} == {"cpu"}


def test_cli_benchmark_fusion_strategies_matches_jax(fx, tmp_path, monkeypatch):
    """--benchmark fusion_strategies on FUSION_GRID (each fusion fitted once
    and evaluated under and, or, score): fusion-MSP-Sigmoid's three rows
    equal the JAX CLI's, the three SDR rows are present, finite and keyed
    alike."""
    fusion_names, strategies = FUSION_GRID
    trows, jrows, _ = _run_both_sweeps(fx, tmp_path, monkeypatch, [
        "--ood_method", "MSP", "--benchmark", "fusion_strategies"],
        {"fusion_strategies": FUSION_GRID}, seed_acts=False)
    assert [(r["Method"], r["fusion_strat"]) for r in trows] == \
        [(f, s) for f in fusion_names for s in strategies]
    _assert_rows_equal(trows[:3], jrows[:3], 3)
    _assert_sdr_rows(trows[3:], jrows[3:])


@pytest.mark.usefixtures("one_thread")
def test_cli_benchmark_used_tpr_matches_jax(fx, tmp_path, monkeypatch):
    trows, jrows, _ = _run_both_sweeps(fx, tmp_path, monkeypatch, [
        "--ood_method", "Cosine_cl_stride", "--cluster_method", "KMeans",
        "--benchmark", "used_tpr"], {"used_tpr": [0.95, 0.8]}, seed_acts=False)
    _assert_rows_equal(trows, jrows, 2)
    assert [r["tpr_thr"] for r in trows] == [0.95, 0.8]


def test_cli_benchmark_unk_loc_enhancement_matches_jax(fx, tmp_path, monkeypatch):
    """The EUL sweep on a cut grid under the BENCHMARK_MODE cache: the JAX
    CLI's rows; the port's forward at the test confidence runs once per OoD
    batch for the whole sweep (the cache serves the second combination),
    one cache entry per batch, and the mode is restored."""
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP as THYP

    grid = {"unk.rank.MAX_NUM_UNK_BOXES_PER_IMAGE": [3, 5], "unk.rank.NMS": [0.5]}
    with _both_hyp():
        trows, jrows, forwards = _run_both_sweeps(fx, tmp_path, monkeypatch, [
            "--ood_method", "Cosine_cl_stride", "--benchmark", "unk_loc_enhancement"],
            {"unk_loc_enhancement": [grid]}, seed_acts=False)
    _assert_rows_equal(trows, jrows, 2)
    assert forwards == len(fx["batches"]["ood"])
    assert len(list((tmp_path / "torch" / "temp").glob("*_eul_*.pkl"))) == \
        len(fx["batches"]["ood"])
    assert THYP.BENCHMARK_MODE is False


def test_benchmark_mode_cache_serves_without_forward(fx, tmp_path, monkeypatch):
    """evaluate_method under BENCHMARK_MODE: the second evaluation of the
    same batches runs no forward and gives the same metrics; the entries
    hold host tensors and P3 only with EUL."""
    import pickle

    from ood_in_object_detection_torch import constants as TC

    monkeypatch.setattr(TC, "TEMPORAL_STORAGE_PATH", tmp_path / "temp")
    monkeypatch.setattr(tpipe.CUSTOM_HYP, "BENCHMARK_MODE", True)
    tm = tmethods.DistanceOODMethod.from_name("Cosine_cl_stride", cluster_method="KMeans_3")
    tpipe.fit_ind_pipeline(tm, tpipe.extract_ind_activations(
        fx["tdet"], fx["batches"]["ind"], tm, conf_thr_train=CONF_TRAIN))
    calls = {"n": 0}
    predict = fx["tdet"].predict

    def counting(*a, **kw):
        calls["n"] += 1
        return predict(*a, **kw)

    monkeypatch.setattr(fx["tdet"], "predict", counting)
    ood = fx["batches"]["ood"]
    for eul in (False, True):
        first = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST,
                                      enhanced_unk_localization=eul)
        n = calls["n"]
        again = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST,
                                      enhanced_unk_localization=eul)
        assert calls["n"] == n and again == first
    entries = sorted((tmp_path / "temp").glob("*.pkl"))
    assert len(entries) == 2 * len(ood)
    for e in entries:
        out = pickle.loads(e.read_bytes())
        assert all(t.device.type == "cpu" for t in out[1:6])
        assert len(out[6]) == (1 if "_eul_" in e.name else 0)
