"""The port's host tools against the JAX package's and scikit-learn, on the
CPU: score metrics (eval/ood_metrics.py), per-box raw scores of a fitted SDR
method, the embedding CLI's own PCA (cli/embedding_plot.py) in each of
scikit-learn's solver regimes, its three modes, the activation dump
(cli/extract_activations.py) and the results tables (cli/process_results.py).
No JAX detector is built: the detectors here are small port models."""

import pickle

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.cli import embedding_plot as temb
from ood_in_object_detection_torch.cli.factory import build_ood_method
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.eval import ood_metrics as tmetrics
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ood.distance import NO_CLUSTER_DISTANCE, pairwise_distance
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)
from ood_in_object_detection_tpu.eval import ood_metrics as jmetrics
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC = 64, 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_metrics_match_jax(seed):
    """auroc, fpr_at_tpr, aupr and ood_score_metrics are the JAX package's
    functions: equal results on seeded scores rounded to create ties."""
    rng = np.random.default_rng(seed)
    ind = np.round(rng.normal(1, 1, 300), 1)
    ood = np.round(rng.normal(0, 1, 200), 1)
    for f in ("auroc", "aupr"):
        assert getattr(tmetrics, f)(ind, ood) == getattr(jmetrics, f)(ind, ood)
    for tpr in (0.95, 0.8):
        assert tmetrics.fpr_at_tpr(ind, ood, tpr) == jmetrics.fpr_at_tpr(ind, ood, tpr)
    assert tmetrics.ood_score_metrics(ind, ood) == jmetrics.ood_score_metrics(ind, ood)
    assert tmetrics.auroc(ind[:0], ood) != tmetrics.auroc(ind[:0], ood)  # nan


@pytest.fixture(scope="module")
def tiny():
    """A seeded yolov8n at 64 px on the CPU (BatchNorm calibrated, head
    spread) and three batches of 4 noise images whose labels are its own
    top detections."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (12, IMG, IMG, 3), dtype=np.uint8)
    det = Detector.create("yolov8n", nc=NC, img_size=IMG, device="cpu")
    calibrate_batchnorm(det.model, torch.from_numpy(images).float().permute(0, 3, 1, 2) / 255)
    load_jax_variables(det.model, spread_detect_head(numpy_state_dict(det.model), seed=1))
    batches = []
    for b in range(3):
        imgs = images[4 * b: 4 * b + 4]
        out = det.predict(imgs, conf_thres=0.25)
        gtb = np.zeros((4, 8, 4), np.float32)
        gtc = np.zeros((4, 8), np.int64)
        gtm = np.zeros((4, 8), bool)
        for i in range(4):
            n = min(int(out.det.valid[i].sum()), 8)
            gtb[i, :n], gtc[i, :n], gtm[i, :n] = out.det.boxes[i, :n], out.det.cls[i, :n], True
        batches.append(dict(images=imgs, gt_bboxes=gtb, gt_labels=gtc, gt_mask=gtm,
                            im_names=[f"b{b}_{i}" for i in range(4)]))
    return det, batches


def test_collect_box_scores_of_an_sdr_method(tiny):
    """collect_box_scores' raw scores for a fitted Umap are, box by box, the
    negated minimum distance to its class's centroids at its stride, with
    the box's feature through the method's host transform (1e-5)."""
    det, batches = tiny
    m = build_ood_method("Umap", device="cpu")
    tpipe.fit_ind_pipeline(m, tpipe.extract_ind_activations(det, batches[:2], m, 0.25))
    assert m.clusters and m.sdr_state["embedders"] is not None
    got = tmetrics.collect_box_scores(det, batches[2:], m, conf_thr=0.25)
    out = det.predict(batches[2]["images"], conf_thres=0.25)
    neck_ch = det.neck_channels()
    want = []
    for i in range(4):
        for j in range(int(out.det.valid[i].sum())):
            c, s = int(out.det.cls[i, j]), int(out.stride_level[i, j])
            cl = m.clusters[c][s]
            if not (isinstance(cl, np.ndarray) and cl.size):
                want.append(-NO_CLUSTER_DISTANCE)
                continue
            z = m.transform(out.roi_feats[i, j, : neck_ch[s]].numpy()[None], c, s)
            d = pairwise_distance(torch.as_tensor(cl, dtype=torch.float32),
                                  torch.as_tensor(z), m.metric)
            want.append(-float(d.min()))
    assert len(got) == len(want) > 10
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _structured(rng, n, d, rank=8, noise=0.05, dtype=np.float32):
    """Rows near a rank-``rank`` subspace with well separated variances."""
    basis = np.linalg.qr(rng.normal(size=(d, rank)))[0].T
    coef = rng.normal(size=(n, rank)) * np.linspace(8, 2, rank)
    return (coef @ basis + noise * rng.normal(size=(n, d)) + rng.normal(size=d)).astype(dtype)


@pytest.mark.parametrize("shape,k,solver,dtype", [
    ((400, 20), 2, "covariance_eigh", np.float32),
    ((600, 50), 50, "covariance_eigh", np.float64),
    ((120, 60), 2, "full", np.float32),
    ((300, 400), 50, "full", np.float64),
    ((501, 60), 50, "full", np.float32),
])
def test_pca_matches_sklearn_exact_solvers(shape, k, solver, dtype):
    """The port's PCA picks scikit-learn 1.9's solver and gives its
    components (signs by svd_flip) and projections: the same LAPACK calls in
    the same order, so equal to 1e-6 of the scale (1e-12 in float64)."""
    from sklearn.decomposition import PCA as SkPCA

    rng = np.random.default_rng(k)
    x, xu = _structured(rng, *shape, dtype=dtype), _structured(rng, 30, shape[1], dtype=dtype)
    ours, ref = temb.PCA(k).fit(x), SkPCA(n_components=k).fit(x)
    assert ours.svd_solver_ == ref._fit_svd_solver == solver
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for a, b in ((ours.components_, ref.components_), (ours.mean_, ref.mean_),
                 (ours.transform(xu), ref.transform(xu)), (ours.transform(x), ref.transform(x))):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("shape", [(600, 300), (300, 600)])
def test_pca_matches_sklearn_randomized(shape):
    """The randomized regime, unseeded as the JAX package calls it, has no
    fixed answer, so the subspace: the port picks scikit-learn's solver name
    and takes the exact SVD, whose projector on rows near a rank-8 subspace
    (k 8) is scikit-learn's unseeded one within 1e-4."""
    from sklearn.decomposition import PCA as SkPCA

    rng = np.random.default_rng(shape[1])
    x = _structured(rng, *shape)
    ours, ref = temb.PCA(8).fit(x), SkPCA(8).fit(x)
    assert ours.svd_solver_ == ref._fit_svd_solver == "randomized"
    assert ours.components_.dtype == ref.components_.dtype == np.float32
    a, b = ours.components_, ref.components_
    np.testing.assert_allclose(a.T @ a, b.T @ b, atol=1e-4)


@pytest.fixture(scope="module")
def acts_file(tmp_path_factory):
    """tests/test_embedding_plot.py's payload: [class][stride] = (N, C),
    4 classes x 3 strides; classes 0-1 known, 2-3 unknown."""
    rng = np.random.default_rng(0)
    acts = []
    for c in range(4):
        per_stride = []
        for ch in (16, 32, 64):
            centre = np.zeros(ch)
            centre[c % ch] = 5.0
            per_stride.append((rng.normal(0, 0.3, (80, ch)) + centre).astype(np.float32))
        acts.append(per_stride)
    f = tmp_path_factory.mktemp("emb") / "acts.pkl"
    f.write_bytes(pickle.dumps({"roi_feats": acts}))
    return str(f)


@pytest.mark.parametrize("mode,extra,files", [
    ("pca", [], ["pca_all.png", "pca_all_known.png"]),
    ("sdr", ["--epochs", "3", "--one_per_stride"], ["sdr_s0.png", "sdr_s1.png", "sdr_s2.png"]),
    ("pca_sdr", ["--epochs", "3", "--stride", "1"], ["pca_sdr_s1.png"]),
])
def test_embedding_plot_modes(acts_file, tmp_path, mode, extra, files):
    """The three modes as tests/test_embedding_plot.py runs them, on the CPU."""
    temb.main(["--activations", acts_file, "--mode", mode, "--number_of_known_classes", "2",
               "--out_dir", str(tmp_path), "--device", "cpu", *extra])
    for f in files:
        assert (tmp_path / f).stat().st_size > 10_000


def test_fit_transform_embeds_known_and_unknown():
    """_fit_transform (what the card's smoke run drives): 2D embeddings of
    the known rows and the unknown rows, PCA's fitted on the known alone."""
    rng = np.random.default_rng(1)
    xk = rng.normal(size=(90, 12)).astype(np.float32)
    yk = rng.integers(0, 3, 90)
    xu = rng.normal(size=(20, 12)).astype(np.float32)
    for mode in ("pca", "sdr", "pca_sdr"):
        ek, eu = temb._fit_transform(mode, xk, yk, xu, epochs=2, k_neighbors=5, device="cpu")
        assert ek.shape == (90, 2) and eu.shape == (20, 2) and np.isfinite(ek).all()
        if mode == "pca":
            pca = temb.PCA(2).fit(xk)
            np.testing.assert_array_equal(ek, pca.transform(xk))
            np.testing.assert_array_equal(eu, pca.transform(xu))


def test_extract_activations_payload(tiny, tmp_path, monkeypatch):
    """cli.extract_activations on a dataset on disk writes the payload of
    extract_ind_activations for MSP and Cosine_cl_stride on the same
    batches: {'logits': [class] (N, nc), 'roi_feats': [class][stride]}."""
    from PIL import Image

    from ood_in_object_detection_torch.cli import extract_activations, ood_eval
    from ood_in_object_detection_torch.data import DetectionDataset, PaddedBatcher
    from ood_in_object_detection_torch.ood.methods import (DistanceOODMethod, FusionOODMethod,
                                                           LogitsOODMethod)

    from ood_in_object_detection_torch.data.native import native_available

    det, batches = tiny
    # settle the letterbox path first: data/native.py's first _load runs
    # unlocked in the batcher's decode threads, so the first batch of a
    # process may letterbox some images natively and some by NumPy (6e-8
    # apart), and the two extractions would then differ (ROADMAP Queue C)
    native_available()
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    names = []
    for b in batches:
        for i, name in enumerate(b["im_names"]):
            Image.fromarray(b["images"][i]).save(tmp_path / "images" / f"{name}.png")
            m = b["gt_mask"][i]
            rows = [f"{c} {(x1 + x2) / 2 / IMG:.6f} {(y1 + y2) / 2 / IMG:.6f} "
                    f"{(x2 - x1) / IMG:.6f} {(y2 - y1) / IMG:.6f}"
                    for (x1, y1, x2, y2), c in zip(b["gt_bboxes"][i][m], b["gt_labels"][i][m])]
            (tmp_path / "labels" / f"{name}.txt").write_text("\n".join(rows) + "\n")
            names.append(f"./images/{name}.png")
    (tmp_path / "split.txt").write_text("\n".join(names) + "\n")
    yaml = tmp_path / "ds.yaml"
    yaml.write_text("path: .\ntrain: split.txt\nval: split.txt\nnames:\n  0: c0\n  1: c1\n")
    monkeypatch.setattr(ood_eval, "load_detector", lambda args, default_nc=20: det)
    out = tmp_path / "out" / "acts.pkl"
    extract_activations.main(["--dataset", str(yaml), "--out", str(out), "--device", "cpu",
                              "--img_size", str(IMG), "--batch_size", "4", "--conf_thr", "0.25"])
    payload = pickle.loads(out.read_bytes())
    ms = [LogitsOODMethod("MSP"), DistanceOODMethod.from_name("Cosine_cl_stride")]
    ds = DetectionDataset.from_yaml(str(yaml), split="train")
    want = tpipe.extract_ind_activations(det, PaddedBatcher(ds, 4, IMG), FusionOODMethod(ms),
                                         0.25)
    assert set(payload) == {"logits", "roi_feats"}
    for a, b in zip(payload["logits"], want[id(ms[0])]):
        np.testing.assert_array_equal(a, b)
    n = 0
    for row_a, row_b in zip(payload["roi_feats"], want[id(ms[1])]):
        for a, b in zip(row_a, row_b):
            np.testing.assert_array_equal(a, b)
            n += len(a)
    assert n > 5 and len(payload["roi_feats"]) == NC


def _write_csv(path, rows):
    import pandas as pd

    pd.DataFrame(rows).to_csv(path, index=False)


def test_process_results_end_to_end(tmp_path):
    """tests/test_process_results.py's end-to-end case on the port's CLI."""
    import pandas as pd

    from ood_in_object_detection_torch.cli.process_results import main

    res = tmp_path / "results"
    res.mkdir()
    _write_csv(res / "a.csv", [
        {"Method": "MSP", "conf_thr_test": 0.45, "mAP_(VOC_test)": 0.69, "U-F1_(COOD)": 0.20},
        {"Method": "MSP", "conf_thr_test": 0.30, "mAP_(VOC_test)": 0.66, "U-F1_(COOD)": 0.22}])
    _write_csv(res / "b.csv", [
        {"Method": "Cosine_cl_stride", "conf_thr_test": 0.50, "mAP_(VOC_test)": 0.64,
         "U-F1_(COOD)": 0.25},
        {"Method": "Energy", "conf_thr_test": 0.45, "mAP_(VOC_test)": 0.60,
         "U-F1_(COOD)": 0.10}])  # dominated
    assert main(["--results_dir", str(res)]) == 0
    out = res / "processed"
    summary = pd.read_csv(out / "summary.csv")
    assert len(summary) == 4 and summary.iloc[0]["U-F1_(COOD)"] == 0.25
    best = pd.read_csv(out / "best_per_method.csv")
    assert set(best["Method"]) == {"MSP", "Cosine_cl_stride", "Energy"}
    assert float(best[best.Method == "MSP"]["U-F1_(COOD)"].iloc[0]) == 0.22
    assert "Energy" not in set(pd.read_csv(out / "pareto.csv")["Method"])
    assert (out / "pareto.png").exists()


def test_pareto_front_matches_jax():
    import pandas as pd

    from ood_in_object_detection_torch.cli.process_results import pareto_front
    from ood_in_object_detection_tpu.cli.process_results import pareto_front as jpareto

    df = pd.DataFrame({"Method": list("abcde"), "x": [1.0, 2.0, 1.5, 0.5, 2.0],
                       "y": [3.0, 1.0, 2.0, 0.5, 1.0]})
    front = pareto_front(df, "x", "y")
    assert list(front["Method"]) == list(jpareto(df, "x", "y")["Method"])
    assert list(front["Method"])[:2] == ["a", "c"]


def test_fusion_scatter_artifact(tmp_path):
    """--fusion_npz renders the score-fusion member scatter PNG."""
    from ood_in_object_detection_torch.cli.process_results import main

    rng = np.random.default_rng(0)
    ind = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200)])
    npz = tmp_path / "fusion.npz"
    np.savez(npz, member_names=np.asarray(["Energy", "L2_cl_stride"]),
             indness=ind.astype(np.float32), decision=(ind.min(axis=0) > 0).astype(np.int32),
             cls=rng.integers(0, 3, 200), conf=rng.uniform(0.2, 1, 200))
    out = tmp_path / "viz" / "scatter.png"
    main(["--fusion_npz", str(npz), "--fusion_out", str(out)])
    assert out.exists() and out.stat().st_size > 10_000
