"""The port's serving bundle against the JAX package's, on the CPU (the
mirror of tests/test_export_viz.py's bundle tests): yolov8n at 64 px, nc 2,
weights shared through ``test_torch_model.shared_weights`` (BatchNorm
calibrated on the compared images, head spread), a fitted ``or`` fusion of
MSP and L2_cl_stride, conf 1e-6, batch 2.

Each package exports its bundle and loads it back with no model code; the
two loaded calls give the same valid masks, classes, anchor indices and
levels and the same per-box decisions, with boxes, confidences, logits and
taps within tests/test_torch_pipeline.py's tolerances (two packages' f32
forwards). The fixture is checked to be non-degenerate first: at conf 1e-6
every anchor is a candidate, so per image the candidates' confidences are
more than 1e-4 apart, no pair's IoU is within 1e-3 of the NMS threshold,
and no kept box's MSP score or L2 distance is within 1e-4 of its
threshold."""

import json
import pickle

import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.ood import methods as jmethods
from ood_in_object_detection_tpu.ood.pipeline import _decisions_for_method as jdecide
from ood_in_object_detection_tpu.utils import export as jexport
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ood import methods as tmethods
from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method as tdecide
from ood_in_object_detection_torch.ops import nms as tnms
from ood_in_object_detection_torch.ops.boxes import box_iou
from ood_in_object_detection_torch.ops.fused_detect import select_candidates
from ood_in_object_detection_torch.utils import export as texport
from test_torch_export import assert_outputs_equal
from test_torch_model import shared_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC, CONF, IOU, BATCH = 64, 2, 1e-6, 0.7, 2
SEED, SPREAD = 6, 0.5  # found by a seed search of test_fixture_is_non_degenerate


def _methods(pkg, neck_ch, seed):
    """A fitted or-fusion of MSP and L2_cl_stride of ``pkg`` (the JAX test's
    recipe): MSP thresholds from seeded scores, two random L2 centroids per
    (class, stride) and thresholds that split the kept boxes."""
    rng = np.random.default_rng(seed)
    msp = pkg.LogitsOODMethod("MSP")
    msp.generate_thresholds([rng.uniform(0.3, 1.0, 40) for _ in range(NC)], 0.95)
    dist = pkg.DistanceOODMethod.from_name("L2_cl_stride")
    dist.clusters = [[rng.normal(0, 1, (2, neck_ch[s])).astype(np.float32) for s in range(3)]
                     for _ in range(NC)]
    # a unit row's L2 distance to a N(0, 1) centroid of C channels is about
    # sqrt(1 + C): thresholds there split the kept boxes
    dist.thresholds = [[float(np.sqrt(1.0 + c)) for c in neck_ch] for _ in range(NC)]
    return pkg.FusionOODMethod([msp, dist], strategy="or")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundles")
    imgs = np.random.default_rng(SEED).uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    calib = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    jm, variables, tm = shared_weights("yolov8n", nc=NC, seed=SEED, calib=calib, spread=SPREAD)
    tdet = Detector(model=tm, img_size=IMG)
    jdet = JaxDetector(model=jm, variables=variables, img_size=IMG)
    neck = tdet.neck_channels()
    tm_, jm_ = _methods(tmethods, neck, SEED), _methods(jmethods, neck, SEED)
    tp = texport.export_serving_bundle(tdet, tm_, root / "torch", batch=BATCH, conf_thres=CONF)
    jp = jexport.export_serving_bundle(jdet, jm_, root / "jax", batch=BATCH, conf_thres=CONF)
    return dict(imgs=imgs, tdet=tdet, tmethod=tm_, tp=tp, jp=jp,
                t=texport.load_serving_bundle(tp, device="cpu"),
                j=jexport.load_serving_bundle(jp))


def test_fixture_is_non_degenerate(bundles):
    tdet, imgs = bundles["tdet"], bundles["imgs"]
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        raw, _ = tdet.model(x)
    cand = select_candidates(raw, NC, CONF, pre_nms_k=1024)
    for i in range(BATCH):
        conf = cand.conf[i]
        assert (conf > CONF).all() and (conf[:-1] - conf[1:]).min() > 1e-4
        shifted, valid = tnms.nms_inputs(cand.boxes[i], conf, cand.cls[i], CONF)
        iou = box_iou(shifted[valid], shifted[valid])
        assert not ((iou - IOU).abs() < 1e-3).any(), "an IoU sits at the NMS threshold"
    out = tdet.predict(imgs, conf_thres=CONF)
    msp = bundles["tmethod"].methods[0]
    v = out.det.valid
    score = msp.raw_scores(out.logits, out.det.cls)[v]
    thr = msp.packed_thresholds()[out.det.cls[v]]
    assert (score - thr).abs().min() > 1e-4
    dist = bundles["tmethod"].methods[1]
    d = -tdecide(dist, out, tdet.neck_channels(), raw=True)
    dthr = torch.tensor(dist.thresholds[0])[out.stride_level]
    assert (d - dthr)[v].abs().min() > 1e-4


def test_bundle_json_has_the_jax_keys(bundles):
    t = json.loads((bundles["tp"] / "bundle.json").read_text())
    j = json.loads((bundles["jp"] / "bundle.json").read_text())
    assert t.keys() == j.keys()
    for k in ("img_size", "batch", "nc", "conf_thres", "neck_channels"):
        assert t[k] == j[k], k
    assert t["platforms"] == ["cpu", "cuda"] and j["platforms"] == ["cpu", "tpu"]
    assert sorted(p.name for p in bundles["tp"].iterdir()) == \
        ["bundle.json", "model.pt2", "ood_method.pkl"]


def test_bundle_matches_jax_bundle(bundles):
    """Each package's loaded bundle on the same images: integer fields and
    decisions equal, floats within the pipeline test's tolerances."""
    imgs = bundles["imgs"]
    tcall, tmeth, tmeta = bundles["t"]
    jcall, jmeth, jmeta = bundles["j"]
    t = tcall(torch.from_numpy(imgs))
    j = jcall(imgs)
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
    assert tmeta["neck_channels"] == jmeta["neck_channels"]
    tdec = tdecide(tmeth, t, tmeta["neck_channels"]).numpy()
    jdec = np.asarray(jdecide(jmeth, j, jmeta["neck_channels"]))
    np.testing.assert_array_equal(tdec, jdec)
    kept = tdec[t.det.valid.numpy()]
    assert 0 < kept.sum() < len(kept), "the decisions must hold an OoD and an InD box"


def test_bundle_matches_live_detector(bundles):
    """The port's bundle, loaded in place of the model, gives the live
    detector's output bit for bit and the live method's decisions."""
    imgs = bundles["imgs"]
    call, method, meta = bundles["t"]
    out = call(torch.from_numpy(imgs))
    live = bundles["tdet"].predict(imgs, conf_thres=CONF)
    assert_outputs_equal(out, live)
    fresh = pickle.loads((bundles["tp"] / "ood_method.pkl").read_bytes())
    assert fresh.methods[1]._banks == {}, "the bundled method carries no bank"
    np.testing.assert_array_equal(
        tdecide(method, out, meta["neck_channels"]).numpy(),
        tdecide(bundles["tmethod"], live, bundles["tdet"].neck_channels()).numpy())
