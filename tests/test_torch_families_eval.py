"""The port's eval path on the other head styles against the JAX package,
on the CPU: uint8 images -> yolov10n (the v10 dual head, decoded on its
one2one maps; yolo11n, the v11 head, takes the same checks in
tests/test_torch_families_eval_v11.py, a file of its own so that tier-1's
workers take the two models apart) -> detect/NMS -> RoI taps -> MSP
and Cosine_cl_stride -> extract -> fit -> evaluate -> OWOD rows, on an
on-disk dataset (96 px, nc=2) with shared weights (tests/test_torch_zoo.py:
zoo_weights, BatchNorm calibrated on the dataset's images), under the
tolerances and non-degeneracy checks of tests/test_torch_pipeline.py, whose
helpers this file reuses; the OWOD rows must be equal. The fitted
thresholds are held to the features' rtol 1e-4 (tests/test_torch_pipeline.py
holds its fixture's to 1e-5): a cosine distance of 0.1 between features that
agree to 1e-4 moves by ~2e-5 of itself here."""

import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.data import DetectionDataset, PaddedBatcher
from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.ood import pipeline as jpipe
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ood import pipeline as tpipe
from ood_in_object_detection_torch.ops import nms as tnms
from ood_in_object_detection_torch.ops.boxes import box_iou
from ood_in_object_detection_torch.ops.fused_detect import select_candidates
from test_torch_pipeline import _flat, _label_from_detections, _methods, _write_images
from test_torch_zoo import zoo_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC, IOU = 96, 2, 0.7
KNOWN, NAMES = [0, 1], ["c0", "c1", "unknown"]
# per model: a seed, head spread and confidence thresholds for which the
# fixture is non-degenerate (test_fixture_is_non_degenerate)
FIXTURES = {"yolov10n": (28, 3.0, 0.8, 0.9), "yolo11n": (26, 2.0, 0.7, 0.8)}


def make_fixture(root, name, seed, spread, conf_train, conf_test):
    images = np.random.default_rng(seed).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    ind_files = _write_images(root, "ind", images[:4])
    ood_files = _write_images(root, "ood", images[4:])
    jm, variables, tm = zoo_weights(name, nc=NC, seed=seed, spread=spread, img=IMG,
                                    calib=images.astype(np.float32) / 255)
    tdet = Detector(model=tm, img_size=IMG)
    _label_from_detections(tdet, ind_files, conf_train)
    _label_from_detections(tdet, ood_files, conf_test, unknown_every=3)
    names = [f"c{k}" for k in range(6)]
    batches = {}
    for split, files in (("ind", ind_files), ("ood", ood_files)):
        ds = DetectionDataset.from_image_list([str(f) for f in files], names, number_of_classes=NC)
        batches[split] = list(PaddedBatcher(ds, batch_size=4, img_size=IMG, max_gt=32,
                                            image_dtype="uint8"))
    jdet = JaxDetector(model=jm, variables=variables, img_size=IMG)
    return dict(tdet=tdet, jdet=jdet, batches=batches, conf_train=conf_train,
                conf_test=conf_test)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_fixture(tmp_path_factory.mktemp("yolov10n"), "yolov10n", *FIXTURES["yolov10n"])


def test_fixture_is_non_degenerate(fx):
    model = fx["tdet"].model
    for split, conf_thres in (("ind", fx["conf_train"]), ("ood", fx["conf_test"])):
        for batch in fx["batches"][split]:
            x = torch.from_numpy(batch["images"]).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
            with torch.no_grad():
                raw = model(x)[0]
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
    confs = torch.cat([fx["tdet"].predict(b["images"], conf_thres=fx["conf_test"]).det.conf
                       .flatten() for b in fx["batches"]["ood"]])
    confs = torch.sort(confs[confs > 0], descending=True).values
    assert len(confs) > 10
    assert (confs[:-1] - confs[1:]).min() > 1e-4, "evaluated confidences nearly tie"


def test_predict_matches_jax(fx):
    images = fx["batches"]["ind"][0]["images"]
    t = fx["tdet"].predict(images, conf_thres=fx["conf_train"])
    j = fx["jdet"].predict(images, conf_thres=fx["conf_train"])
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


@pytest.mark.parametrize("method", ["MSP", "Cosine_cl_stride"])
def test_extract_fit_evaluate_match_jax(fx, method):
    jm, tm = _methods(method)
    ind, ood = fx["batches"]["ind"], fx["batches"]["ood"]
    ct, cv = fx["conf_train"], fx["conf_test"]
    jacts = jpipe.extract_ind_activations(fx["jdet"], ind, jm, conf_thr_train=ct)
    tacts = tpipe.extract_ind_activations(fx["tdet"], ind, tm, conf_thr_train=ct)
    jflat = jacts[id(jm)] if method == "MSP" else [a for row in jacts[id(jm)] for a in row]
    tflat = tacts[id(tm)] if method == "MSP" else [a for row in tacts[id(tm)] for a in row]
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
    # a threshold is a distance of features held to 1e-4: no tighter
    np.testing.assert_allclose(tt, jt, rtol=1e-4)

    neck_j, neck_t = fx["jdet"].neck_channels(), fx["tdet"].neck_channels()
    assert tuple(neck_j) == tuple(neck_t)
    verdicts = []
    for batch in ood:
        jout = fx["jdet"].predict(batch["images"], conf_thres=cv)
        tout = fx["tdet"].predict(batch["images"], conf_thres=cv)
        jdec = np.asarray(jpipe._decisions_for_method(jm, jout, neck_j))
        tdec = tpipe._decisions_for_method(tm, tout, neck_t).numpy()
        np.testing.assert_array_equal(tdec, jdec)
        # decisions are not a coin flip at the threshold: scores keep a margin
        jraw = np.asarray(jpipe._decisions_for_method(jm, jout, neck_j, raw=True))
        thr = (np.nan_to_num(np.asarray(jm.packed_thresholds()), nan=0.0)
               if method == "MSP" else -np.asarray(jm.packed_thresholds()))
        cls, lvl, valid = (np.asarray(jout.det.cls), np.asarray(jout.stride_level),
                           np.asarray(jout.det.valid))
        box_thr = thr[cls] if method == "MSP" else thr[cls, lvl]
        gap = np.abs(jraw - box_thr)[valid & np.isfinite(box_thr)]
        assert gap.min() > 1e-4 * max(1.0, np.abs(box_thr[np.isfinite(box_thr)]).max())
        verdicts.append(tdec[valid])
    verdicts = np.concatenate(verdicts)
    if method != "MSP":
        assert 0 < verdicts.sum() < len(verdicts), "every box got the same verdict"
    jres = jpipe.evaluate_method(fx["jdet"], ood, jm, KNOWN, NAMES, conf_thr_test=cv)
    tres = tpipe.evaluate_method(fx["tdet"], ood, tm, KNOWN, NAMES, conf_thr_test=cv)
    assert set(tres) == {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}
    assert tres == jres
