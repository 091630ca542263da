"""Data-parallel inference on the CPU (``engine.Detector.predict_sharded``,
``serving.MicroBatchServer(mesh=)``) against the JAX package's
``predict_sharded`` and against the port's own ``predict``.

Fixture: yolov8n at 96 px, nc 2, the JAX init carried into torch,
BatchNorm-calibrated on the 8 images and head-spread (test_torch_pipeline's
seed 14 and spread 2.0, whose confidences and IoUs keep their margins), conf
0.7: 210 detections, so that integer outputs can be demanded exactly.

Tolerances. A mesh of 8 'cpu' entries predicts each image alone, and on
this fixture a batch of one moves the f32 outputs as far as another
package does: boxes up to 6.0e-4 px from the batch of 8, RoI taps 2.0e-5,
exact taps 6.2e-5 (JAX's own sharded-vs-single run reads 5.5e-4 px, 1.5e-5
and ~5e-5 here: its DP test's rtol 1e-5 / atol 1e-4 on boxes and 1e-5 on the
taps hold only on the degenerate outputs of its random init). So the
8-entry mesh is held against JAX's and against the port's single predict
with the port-vs-JAX tolerances of test_torch_pipeline.test_predict_matches_jax
(boxes rtol 1e-4 / atol 2e-3, taps rtol 1e-4 / atol 1e-4 of the largest
magnitude); shards of 4 (a 2-entry mesh) with the JAX DP test's own."""

import numpy as np
import pytest
import torch
from test_torch_model import shared_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.parallel import make_mesh
from ood_in_object_detection_torch.serving import MicroBatchServer
from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.parallel import make_mesh as jax_make_mesh

IMG, NC, SEED, SPREAD, CONF = 96, 2, 14, 2.0, 0.7
INTS = ("valid", "cls", "anchor_idx")
CROSS = dict(boxes=dict(rtol=1e-4, atol=2e-3), conf=dict(rtol=1e-4, atol=1e-6), taps=1e-4)
JAX_DP = dict(boxes=dict(rtol=1e-5, atol=1e-4), conf=dict(rtol=1e-5, atol=1e-6), taps=1e-5)


@pytest.fixture(scope="module")
def fx():
    images = np.random.default_rng(SEED).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    calib = torch.from_numpy(images).float().permute(0, 3, 1, 2) * (1 / 255)
    jm, variables, tm = shared_weights("yolov8n", nc=NC, seed=SEED, calib=calib, spread=SPREAD)
    return dict(images=images, tdet=Detector(model=tm, img_size=IMG),
                jdet=JaxDetector(model=jm, variables=variables, img_size=IMG))


def assert_same(got, want, tol):
    """Integer outputs equal, floats within ``tol`` (``taps``: rtol and
    atol as a share of the largest magnitude)."""
    for f in INTS:
        np.testing.assert_array_equal(np.asarray(getattr(got.det, f)),
                                      np.asarray(getattr(want.det, f)), err_msg=f)
    np.testing.assert_array_equal(np.asarray(got.stride_level), np.asarray(want.stride_level))
    np.testing.assert_allclose(np.asarray(got.det.boxes), np.asarray(want.det.boxes),
                               **tol["boxes"])
    np.testing.assert_allclose(np.asarray(got.det.conf), np.asarray(want.det.conf), **tol["conf"])
    for a, b in ((got.roi_feats, want.roi_feats), (got.exact_feats, want.exact_feats)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=tol["taps"],
                                   atol=tol["taps"] * np.abs(b).max())


def test_fixture_has_detections_to_compare(fx):
    out = fx["tdet"].predict(fx["images"], conf_thres=CONF)
    assert int(out.det.valid.sum()) > 100 and (out.det.valid.sum(1) > 5).all()


def test_predict_sharded_matches_jax(fx):
    """8 'cpu' entries against JAX's predict_sharded on make_mesh(data=8)
    (8 virtual devices), the same exported weights: valid, classes, anchors,
    levels (so keep counts) equal; floats within the port-vs-JAX tolerances."""
    got = fx["tdet"].predict_sharded(fx["images"], make_mesh(devices=["cpu"] * 8),
                                     conf_thres=CONF)
    want = fx["jdet"].predict_sharded(fx["images"], jax_make_mesh(data=8), conf_thres=CONF)
    assert got.det.boxes.shape == np.asarray(want.det.boxes).shape
    assert_same(got, want, CROSS)


@pytest.mark.parametrize("entries,tol", [(8, CROSS), (2, JAX_DP)])
def test_predict_sharded_matches_port_predict(fx, entries, tol):
    """The mesh against the port's predict of the whole batch, in batch
    order, every output (the neck maps too) gathered on the first device."""
    det = fx["tdet"]
    got = det.predict_sharded(fx["images"], make_mesh(devices=["cpu"] * entries),
                              conf_thres=CONF)
    want = det.predict(fx["images"], conf_thres=CONF)
    assert_same(got, want, tol)
    for a, b in zip(got.neck, want.neck):
        assert a.shape == b.shape
    with pytest.raises(ValueError, match="divide"):
        det.predict_sharded(fx["images"][:6], make_mesh(devices=["cpu"] * 4))


def test_replicas_are_copies_cached_per_mesh_and_weights(fx):
    """A second device (the CPU as 'cpu:0', another torch.device) gets a
    deep copy of the model that shares no storage with it, made once per
    mesh and weights; an in-place weight change evicts it."""
    images = fx["images"][:4]
    det = Detector(model=fx["tdet"].model, img_size=IMG)
    mesh = make_mesh(devices=["cpu", "cpu:0"])
    got = det.predict_sharded(images, mesh, conf_thres=CONF)
    assert_same(got, det.predict(images, conf_thres=CONF), JAX_DP)
    reps = det._replicas[2]
    rep = reps[torch.device("cpu:0")]
    assert reps[torch.device("cpu")] is det.model and rep is not det.model
    own = {t.data_ptr() for t in list(det.model.parameters()) + list(det.model.buffers())}
    assert not own & {t.data_ptr() for t in list(rep.parameters()) + list(rep.buffers())}
    det.predict_sharded(images, mesh, conf_thres=CONF)
    assert det._replicas[2] is reps  # cached
    original = {k: v.clone() for k, v in det.model.state_dict().items()}
    try:
        with torch.no_grad():
            det.model.model[22].cv3[0][2].bias.add_(0.5)  # loaded in place
        moved = det.predict_sharded(images, mesh, conf_thres=CONF)
        assert det._replicas[2] is not reps
        assert_same(moved, det.predict(images, conf_thres=CONF), JAX_DP)
        assert not torch.equal(moved.det.conf, got.det.conf)
    finally:
        det.model.load_state_dict(original)


def test_server_over_a_mesh_equals_the_unsharded_server(fx):
    """MicroBatchServer(mesh=) serves each request the same detections as
    the server without a mesh (one full group each, shards of 2); a batch
    that does not divide over the mesh is refused."""
    det, images = fx["tdet"], fx["images"][:4]
    mesh = make_mesh(devices=["cpu"] * 2)
    served = {}
    for key, m in (("mesh", mesh), ("single", None)):
        with MicroBatchServer(det, batch_size=4, max_wait_ms=2000, conf_thres=CONF,
                              mesh=m) as srv:
            futs = [srv.submit(im) for im in images]
            served[key] = [f.result() for f in futs]
    for a, b in zip(served["mesh"], served["single"]):
        assert a["num_valid"] == b["num_valid"] > 0
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(a["conf"], b["conf"], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        MicroBatchServer(det, batch_size=3, mesh=mesh)
