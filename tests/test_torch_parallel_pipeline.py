"""The OoD pipeline and the CLIs over a device mesh on the CPU
(``ood/pipeline.py`` with ``mesh=``, ``cli.ood_eval --data_parallel``,
``cli.predict --data_parallel``) against the same runs on one device, as
tests/test_pipeline_e2e.py:146-200 holds the JAX package's: thresholds and
OWOD metric rows within rtol 1e-5, EUL's proposals equal.

Fixture: a seeded yolov8n of the port at 96 px, nc 2, BatchNorm calibrated
on its 8 images and head-spread; 4 InD and 4 OoD images on disk, labelled
with the model's own detections (every third OoD box of class 5, unknown).
Meshes of 'cpu' entries stand for cards; batches of 4 split into shards of
2 on a 2-entry mesh."""

import json

import numpy as np
import pytest
import torch
from test_torch_pipeline import _label_from_detections, _write_images, _write_yamls
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch import constants as C
from ood_in_object_detection_torch.cli import ood_eval
from ood_in_object_detection_torch.cli import predict as tpredict
from ood_in_object_detection_torch.data import DetectionDataset, PaddedBatcher
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ood.methods import DistanceOODMethod, LogitsOODMethod
from ood_in_object_detection_torch.parallel import make_mesh
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)

IMG, NC, SEED, SPREAD, CONF_TRAIN, CONF_TEST = 96, 2, 14, 2.0, 0.7, 0.8
KNOWN, NAMES = [0, 1], ["c0", "c1", "unknown"]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dp")
    images = np.random.default_rng(SEED).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    det = Detector.create("yolov8n", nc=NC, img_size=IMG, device="cpu",
                          generator=torch.Generator().manual_seed(SEED))
    calibrate_batchnorm(det.model, torch.from_numpy(images).float().permute(0, 3, 1, 2) / 255)
    load_jax_variables(det.model, spread_detect_head(numpy_state_dict(det.model), seed=SEED + 1,
                                                     scale=SPREAD))
    det.model.eval()
    ind_files = _write_images(root, "ind", images[:4])
    ood_files = _write_images(root, "ood", images[4:])
    _label_from_detections(det, ind_files, CONF_TRAIN)
    _label_from_detections(det, ood_files, CONF_TEST, unknown_every=3)
    _write_yamls(root)
    names = [f"c{k}" for k in range(6)]
    batches = {}
    for split, files in (("ind", ind_files), ("ood", ood_files)):
        ds = DetectionDataset.from_image_list([str(f) for f in files], names,
                                              number_of_classes=NC)
        batches[split] = list(PaddedBatcher(ds, batch_size=4, img_size=IMG, max_gt=32,
                                            image_dtype="uint8"))
    return dict(root=root, det=det, batches=batches, mesh=make_mesh(devices=["cpu"] * 2))


def _flat(thresholds):
    out = []
    for t in thresholds:
        out.extend(_flat(t) if isinstance(t, list) else [np.nan if t is None else t])
    return np.asarray(out, np.float64)


def _method(name):
    if name == "MSP":
        return LogitsOODMethod("MSP")
    return DistanceOODMethod.from_name(name, cluster_method="one")


def _run(fx, name, mesh, **eval_kw):
    m = _method(name)
    acts = tpipe.extract_ind_activations(fx["det"], fx["batches"]["ind"], m,
                                         conf_thr_train=CONF_TRAIN, mesh=mesh)
    tpipe.fit_ind_pipeline(m, acts, tpr=0.95)
    res = tpipe.evaluate_method(fx["det"], fx["batches"]["ood"], m, KNOWN, NAMES,
                                conf_thr_test=CONF_TEST, mesh=mesh, **eval_kw)
    return m, res


def _assert_rows_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["MSP", "Cosine_cl_stride"])
def test_extract_fit_evaluate_over_the_mesh(fx, name):
    m1, res1 = _run(fx, name, None)
    mm, resm = _run(fx, name, fx["mesh"])
    t1, tm = _flat(m1.thresholds), _flat(mm.thresholds)
    assert np.isfinite(t1).sum() > 0
    np.testing.assert_array_equal(np.isnan(tm), np.isnan(t1))
    np.testing.assert_allclose(tm, t1, rtol=1e-5, atol=1e-7)
    assert res1["mAP"] > 0
    _assert_rows_close(resm, res1)


def test_eul_over_the_mesh(fx, monkeypatch):
    """evaluate_method with enhanced_unk_localization over the mesh: the
    same proposals per image (the gathered P3 on the mesh's first device)
    and the same metrics as on one device."""
    seen = {}
    orig = tpipe.finish_unknown_proposals

    def record(cands, *a, **k):
        out = orig(cands, *a, **k)
        seen.setdefault(key, []).append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(tpipe, "finish_unknown_proposals", record)
    res = {}
    for key, mesh in (("single", None), ("mesh", fx["mesh"])):
        res[key] = _run(fx, "Cosine_cl_stride", mesh, enhanced_unk_localization=True)[1]
    assert len(seen["mesh"]) == len(seen["single"]) == 4
    assert sum(len(p) for p in seen["single"]) > 0
    for a, b in zip(seen["mesh"], seen["single"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    _assert_rows_close(res["mesh"], res["single"])


def test_fusion_scores_over_the_mesh(fx):
    from ood_in_object_detection_torch.cli.factory import build_ood_method

    fusion = build_ood_method("fusion-MSP-Cosine_cl_stride", "one", "silhouette", "score",
                              device="cpu")
    acts = tpipe.extract_ind_activations(fx["det"], fx["batches"]["ind"], fusion,
                                         conf_thr_train=CONF_TRAIN)
    tpipe.fit_ind_pipeline(fusion, acts, tpr=0.95)
    got = {key: tpipe.collect_fusion_member_indness(fx["det"], fx["batches"]["ood"], fusion,
                                                    conf_thr_test=CONF_TEST, mesh=mesh)
           for key, mesh in (("single", None), ("mesh", fx["mesh"]))}
    assert got["single"]["indness"].shape[1] > 10
    for k in ("decision", "cls"):
        np.testing.assert_array_equal(got["mesh"][k], got["single"][k])
    for k in ("indness", "conf"):
        np.testing.assert_allclose(got["mesh"][k], got["single"][k], rtol=1e-5, atol=1e-6)


def _cli_args(fx, *extra):
    root = fx["root"]
    return ["--model", "n", "--ind_dataset", str(root / "ind.yaml"),
            "--ood_datasets", str(root / "ood.yaml"), "--conf_thr_train", str(CONF_TRAIN),
            "--conf_thr_test", str(CONF_TEST), "--img_size", str(IMG), "--batch_size", "4",
            *extra]


def test_ood_eval_cli_data_parallel(fx, tmp_path, monkeypatch):
    """--data_parallel --device cpu,cpu gives the metric row of the run on
    one device (Cosine_cl_stride with EUL); a batch that does not divide
    over the mesh, or several entries without the flag, raise."""
    monkeypatch.setattr(ood_eval, "load_detector", lambda args, default_nc=20: fx["det"])
    rows = {}
    for key, dev in (("single", ["--device", "cpu"]),
                     ("mesh", ["--device", "cpu,cpu", "--data_parallel"])):
        monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / key / "results")
        monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / key / "storage")
        (row,) = ood_eval.main(["--ood_method", "Cosine_cl_stride", "--name", key,
                                "--enhanced_unk_localization", *_cli_args(fx, *dev)])
        rows[key] = row
    assert "'data_parallel': True" in rows["mesh"]["args"]
    from ood_in_object_detection_torch.eval.results_writer import dataset_result_columns

    cols = dataset_result_columns("coco_ood")
    assert rows["single"]["U-AP_(COOD)"] > 0
    for c in cols:
        np.testing.assert_allclose(rows["mesh"][c], rows["single"][c], rtol=1e-5, atol=1e-7,
                                   err_msg=c)
    with pytest.raises(ValueError, match="divide"):
        ood_eval.main(["--ood_method", "MSP", *_cli_args(fx, "--device", "cpu,cpu,cpu",
                                                         "--data_parallel")])
    with pytest.raises(ValueError, match="need --data_parallel"):
        ood_eval.main(["--ood_method", "MSP", *_cli_args(fx, "--device", "cpu,cpu")])


def test_predict_cli_data_parallel(fx, tmp_path, monkeypatch):
    """cli.predict --data_parallel --device cpu,cpu writes the predictions of
    the run on one device; a batch that does not divide raises."""
    monkeypatch.setattr(tpredict, "build_detector", lambda args: (fx["det"], NC))
    preds = {}
    for key, dev in (("single", ["--device", "cpu"]),
                     ("mesh", ["--device", "cpu,cpu", "--data_parallel"])):
        out = tmp_path / key
        tpredict.main(["--source", str(fx["root"] / "ood" / "images"), "--img_size", str(IMG),
                       "--batch_size", "4", "--conf", str(CONF_TEST), "--no_save", "--save_json",
                       "--save_dir", str(out), *dev])
        preds[key] = json.loads((out / "predictions.json").read_text())
    assert len(preds["single"]) > 10 and len(preds["mesh"]) == len(preds["single"])
    for a, b in zip(preds["mesh"], preds["single"]):
        assert (a["image"], a["category"]) == (b["image"], b["category"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=1e-5, atol=1e-4)
        assert abs(a["score"] - b["score"]) <= 1e-6
    with pytest.raises(ValueError, match="divide"):
        tpredict.main(["--source", "x", "--batch_size", "3", "--device", "cpu,cpu",
                       "--data_parallel"])
