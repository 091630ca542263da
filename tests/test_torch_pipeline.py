"""The ported slice as a whole against the JAX package, on the CPU:
uint8 images -> YOLOv8n forward -> detect/NMS -> RoI taps -> MSP and
Cosine_cl_stride -> extract -> fit -> evaluate -> OWOD metrics, on an
on-disk dataset (96 px, nc=2) and shared weights (the JAX init carried into
torch, BatchNorm-calibrated and head-spread there, and imported back).

Integer outputs are demanded exactly, so the test first asserts that the
fixture is non-degenerate: per image, consecutive candidate confidences are
more than 1e-4 apart, and so are all evaluated detections' confidences (the
OWOD protocol ranks them across images); no candidate pair's IoU is within
1e-3 of the NMS threshold; and no evaluated box's score is within 1e-4 of
its threshold.
Ground-truth boxes are the torch model's own detections, written as labels,
so that the Hungarian matching of the InD extraction is not empty."""

import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.data import DetectionDataset, PaddedBatcher
from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood import pipeline as jpipe
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ops import nms as tnms
from ood_in_object_detection_torch.ops.boxes import box_iou
from ood_in_object_detection_torch.ops.fused_detect import select_candidates
from test_torch_model import shared_weights

IMG, NC, IOU = 96, 2, 0.7
KNOWN, NAMES = [0, 1], ["c0", "c1", "unknown"]
# a seed, head spread and confidence thresholds for which the fixture is
# non-degenerate (test_fixture_is_non_degenerate): 107 InD detections to
# fit on, 33 evaluated detections. A small spread keeps the logits, and so
# the f32 differences between the two packages' forwards, small.
SEED, SPREAD, CONF_TRAIN, CONF_TEST = 14, 2.0, 0.7, 0.8


def _write_images(root, name, images):
    from PIL import Image

    (root / name / "images").mkdir(parents=True)
    (root / name / "labels").mkdir()
    files = []
    for i, img in enumerate(images):
        f = root / name / "images" / f"{name}{i}.png"
        Image.fromarray(img).save(f)
        files.append(f)
    return files


def _label_from_detections(det: Detector, files, conf: float, unknown_every: int = 0):
    """Write each image's top detections as its YOLO labels; with
    ``unknown_every`` > 0 every that-many-th box gets the unknown class 5."""
    from PIL import Image

    images = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
    out = det.predict(images, conf_thres=conf, iou_thres=IOU)
    for i, f in enumerate(files):
        n = min(int(out.det.valid[i].sum()), 30)
        lines = []
        for j in range(n):
            x1, y1, x2, y2 = (out.det.boxes[i, j].numpy() / IMG).tolist()
            c = 5 if unknown_every and j % unknown_every == unknown_every - 1 else int(out.det.cls[i, j])
            lines.append(f"{c} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}")
        (f.parent.parent / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    images = np.random.default_rng(SEED).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    ind_files = _write_images(root, "ind", images[:4])
    ood_files = _write_images(root, "ood", images[4:])
    calib = torch.from_numpy(images).float().permute(0, 3, 1, 2) * (1 / 255)
    jm, variables, tm = shared_weights("yolov8n", nc=NC, seed=SEED, calib=calib, spread=SPREAD)
    tdet = Detector(model=tm, img_size=IMG)
    _label_from_detections(tdet, ind_files, CONF_TRAIN)
    _label_from_detections(tdet, ood_files, CONF_TEST, unknown_every=3)
    names = [f"c{k}" for k in range(6)]
    ind = DetectionDataset.from_image_list([str(f) for f in ind_files], names, number_of_classes=NC)
    ood = DetectionDataset.from_image_list([str(f) for f in ood_files], names, number_of_classes=NC)
    batches = {k: list(PaddedBatcher(ds, batch_size=4, img_size=IMG, max_gt=32, image_dtype="uint8"))
               for k, ds in (("ind", ind), ("ood", ood))}
    jdet = JaxDetector(model=jm, variables=variables, img_size=IMG)
    return dict(root=root, tdet=tdet, jdet=jdet, batches=batches)


def test_fixture_is_non_degenerate(fx):
    model = fx["tdet"].model
    for split, conf_thres in (("ind", CONF_TRAIN), ("ood", CONF_TEST)):
        for batch in fx["batches"][split]:
            x = torch.from_numpy(batch["images"]).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
            with torch.no_grad():
                raw, _ = model(x)
            cand = select_candidates(raw, NC, conf_thres, pre_nms_k=1024)
            for i in range(len(x)):
                conf = cand.conf[i][cand.conf[i] > conf_thres]
                assert len(conf) > 1
                assert (conf[:-1] - conf[1:]).min() > 1e-4, "candidate confidences nearly tie"
                shifted, valid = tnms.nms_inputs(cand.boxes[i], cand.conf[i], cand.cls[i],
                                                 conf_thres)
                iou = box_iou(shifted[valid], shifted[valid])
                assert not ((iou - IOU).abs() < 1e-3).any(), "an IoU sits at the NMS threshold"
            assert batch["gt_mask"].sum() > 0
    confs = torch.cat([fx["tdet"].predict(b["images"], conf_thres=CONF_TEST).det.conf.flatten()
                       for b in fx["batches"]["ood"]])
    confs = torch.sort(confs[confs > 0], descending=True).values
    assert len(confs) > 10
    assert (confs[:-1] - confs[1:]).min() > 1e-4, "evaluated confidences nearly tie"


def test_predict_matches_jax(fx):
    images = fx["batches"]["ind"][0]["images"]
    t = fx["tdet"].predict(images, conf_thres=CONF_TRAIN)
    j = fx["jdet"].predict(images, conf_thres=CONF_TRAIN)
    for field in ("valid", "cls", "anchor_idx"):
        np.testing.assert_array_equal(getattr(t.det, field).numpy(),
                                      np.asarray(getattr(j.det, field)), err_msg=field)
    np.testing.assert_array_equal(t.stride_level.numpy(), np.asarray(j.stride_level))
    assert t.det.valid.sum() > 20
    np.testing.assert_allclose(t.det.boxes.numpy(), np.asarray(j.det.boxes), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(t.det.conf.numpy(), np.asarray(j.det.conf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits), rtol=1e-4, atol=1e-3)
    for a, b in ((t.roi_feats, j.roi_feats), (t.exact_feats, j.exact_feats)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def _methods(name):
    if name == "MSP":
        return jmethods.LogitsOODMethod("MSP"), tmethods.LogitsOODMethod("MSP")
    return jmethods.DistanceOODMethod.from_name(name), tmethods.DistanceOODMethod.from_name(name)


def _flat(thresholds):
    out = []
    for t in thresholds:
        out.extend(_flat(t) if isinstance(t, list) else [np.nan if t is None else t])
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("name", ["MSP", "Cosine_cl_stride"])
def test_extract_fit_evaluate_match_jax(fx, name):
    jm, tm = _methods(name)
    ind, ood = fx["batches"]["ind"], fx["batches"]["ood"]
    jacts = jpipe.extract_ind_activations(fx["jdet"], ind, jm, conf_thr_train=CONF_TRAIN)
    tacts = tpipe.extract_ind_activations(fx["tdet"], ind, tm, conf_thr_train=CONF_TRAIN)
    jflat = jacts[id(jm)] if name == "MSP" else [a for row in jacts[id(jm)] for a in row]
    tflat = tacts[id(tm)] if name == "MSP" else [a for row in tacts[id(tm)] for a in row]
    assert sum(len(a) for a in tflat) > 10, "no matched InD boxes: the fit would be empty"
    for a, b in zip(tflat, jflat):
        assert a.shape == b.shape
        if a.size:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())

    jpipe.fit_ind_pipeline(jm, jacts, tpr=0.95)
    tpipe.fit_ind_pipeline(tm, tacts, tpr=0.95)
    jt, tt = _flat(jm.thresholds), _flat(tm.thresholds)
    assert np.isfinite(tt).sum() > 0
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    if name != "MSP":
        assert sum(isinstance(c, np.ndarray) and c.ndim == 2 for row in tm.clusters for c in row) > 0

    neck_j, neck_t = fx["jdet"].neck_channels(), fx["tdet"].neck_channels()
    assert tuple(neck_j) == tuple(neck_t)
    verdicts = []
    for batch in ood:
        jout = fx["jdet"].predict(batch["images"], conf_thres=CONF_TEST)
        tout = fx["tdet"].predict(batch["images"], conf_thres=CONF_TEST)
        jdec = np.asarray(jpipe._decisions_for_method(jm, jout, neck_j))
        tdec = tpipe._decisions_for_method(tm, tout, neck_t).numpy()
        np.testing.assert_array_equal(tdec, jdec)
        # decisions are not a coin flip at the threshold: scores keep a margin
        jraw = np.asarray(jpipe._decisions_for_method(jm, jout, neck_j, raw=True))
        thr = (np.nan_to_num(np.asarray(jm.packed_thresholds()), nan=0.0)
               if name == "MSP" else -np.asarray(jm.packed_thresholds()))
        cls, lvl, valid = (np.asarray(jout.det.cls), np.asarray(jout.stride_level),
                           np.asarray(jout.det.valid))
        box_thr = thr[cls] if name == "MSP" else thr[cls, lvl]
        gap = np.abs(jraw - box_thr)[valid & np.isfinite(box_thr)]
        assert gap.min() > 1e-4 * max(1.0, np.abs(box_thr[np.isfinite(box_thr)]).max())
        verdicts.append(tdec[valid])

    verdicts = np.concatenate(verdicts)
    if name != "MSP":  # MSP calls every box kept at CONF_TEST in-distribution here
        assert 0 < verdicts.sum() < len(verdicts), "every box got the same verdict"
    jres = jpipe.evaluate_method(fx["jdet"], ood, jm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    tres = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=CONF_TEST)
    assert set(tres) == {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}
    assert tres == jres


def test_cli_runs_on_fixture(fx, tmp_path, monkeypatch):
    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval

    root = fx["root"]
    for split in ("ind", "ood"):
        (root / f"{split}.txt").write_text("\n".join(
            f"./{split}/images/{p.name}" for p in sorted((root / split / "images").iterdir())))
        (root / f"{split}.yaml").write_text(
            f"path: .\ntrain: {split}.txt\nval: {split}.txt\nnames:\n  0: c0\n  1: c1\n")
    monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / "results")
    monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / "storage")
    monkeypatch.setattr(ood_eval, "load_detector", lambda args, default_nc=20: fx["tdet"])
    rows = ood_eval.main([
        "--ood_method", "Cosine_cl_stride", "--model", "n", "--device", "cpu",
        "--ind_dataset", str(root / "ind.yaml"), "--ood_datasets", str(root / "ood.yaml"),
        "--conf_thr_train", str(CONF_TRAIN), "--conf_thr_test", str(CONF_TEST),
        "--img_size", str(IMG), "--batch_size", "4", "--name", "torchsmoke"])
    assert len(rows) == 1 and rows[0]["Method"] == "Cosine_cl_stride"
    assert len(list((tmp_path / "results").glob("*torchsmoke.csv"))) == 1


@pytest.mark.parametrize("flag", [["--enhanced_unk_localization"],
                                  ["--data_parallel"], ["--cluster_method", "KMeans_3"]])
def test_cli_unported_flags_raise(flag):
    from ood_in_object_detection_torch.cli import ood_eval

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ood_eval.main(["--ood_method", "MSP", "--ind_dataset", "x.yaml",
                       "--ood_datasets", "y.yaml", *flag])
