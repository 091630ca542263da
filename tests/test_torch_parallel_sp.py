"""Spatial parallelism against the JAX package on the CPU: the port's
``Detector.predict_sharded`` over a mesh whose ``sp`` axis splits the image
height (parallel/spatial.py, halos exchanged by hand) against the JAX
package's ``predict_sharded`` over the same mesh shape (XLA's SPMD
partitioner, the conftest's 8 virtual devices), yolov8n at 64 px, the same
weights, images from a numpy seed; meshes data 4 x sp 2 and data 2 x sp 2 x
model 2 (8 'cpu' entries).

Two fixtures:

- the JAX test's own (tests/test_parallel.py:88-103): the JAX random init
  carried into torch, nc 4, conf 1e-6, pre_nms_k 128, held with its
  tolerances (boxes rtol 1e-5 / atol 1e-4, ``valid`` equal, RoI rtol 1e-5 /
  atol 1e-5). Its activations shrink to ~0 with depth (RoI taps below 7.6e-6,
  under the atol), so it also runs:
- a calibrated one (test_torch_parallel_predict's recipe at 64 px: BatchNorm
  calibrated on the images, head spread 2.0, conf 0.5, 209 detections):
  integer outputs equal, floats within the port-vs-JAX tolerances (boxes
  rtol 1e-4 / atol 2e-3: a batch shard of one image moves boxes by up to
  8.4e-4 px between the packages here, as test_torch_parallel_predict
  explains), and the port's sharded predict against its own unsharded
  predict: within the JAX test's tolerances on shards of 2 images, the
  port-vs-JAX ones on shards of one (the batch of one, 6.7e-4 px here)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_model import shared_weights
from test_torch_parallel_predict import CROSS, JAX_DP, assert_same
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.models import build_model
from ood_in_object_detection_torch.parallel import make_mesh
from ood_in_object_detection_torch.utils.weights import load_jax_variables
from ood_in_object_detection_tpu.engine import Detector as JaxDetector
from ood_in_object_detection_tpu.parallel import make_mesh as jax_make_mesh
from ood_in_object_detection_tpu.utils.weight_import import export_state_dict

IMG, SEED, SPREAD, CONF = 64, 14, 2.0, 0.5
MESHES = [dict(data=4, sp=2), dict(data=2, sp=2, model=2)]
SELF_TOL = [CROSS, JAX_DP]  # the sharded predict against the port's own, per mesh


@pytest.fixture(scope="module")
def random_init():
    """The JAX test's detector and the same weights in the port."""
    jdet = JaxDetector.create("yolov8n", nc=4, img_size=IMG)
    tm = build_model("yolov8n", nc=4)
    load_jax_variables(tm, export_state_dict(jdet.variables, detect_layer_idx=tm.detect_layer_idx))
    return jdet, Detector(model=tm.eval(), img_size=IMG)


@pytest.fixture(scope="module")
def calibrated():
    images = np.random.default_rng(SEED).integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    calib = torch.from_numpy(images).float().permute(0, 3, 1, 2) * (1 / 255)
    jm, variables, tm = shared_weights("yolov8n", nc=2, seed=SEED, calib=calib, spread=SPREAD)
    return dict(images=images, tdet=Detector(model=tm, img_size=IMG),
                jdet=JaxDetector(model=jm, variables=variables, img_size=IMG))


@pytest.mark.parametrize("axes", MESHES)
def test_sp_predict_matches_jax_on_its_test_fixture(random_init, axes):
    jdet, tdet = random_init
    images = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (4, IMG, IMG, 3)))
    got = tdet.predict_sharded(images, make_mesh(devices=["cpu"] * 8, **axes),
                               conf_thres=1e-6, pre_nms_k=128)
    want = jdet.predict_sharded(images, jax_make_mesh(**axes), conf_thres=1e-6, pre_nms_k=128)
    np.testing.assert_allclose(got.det.boxes.numpy(), np.asarray(want.det.boxes),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.det.valid.numpy(), np.asarray(want.det.valid))
    np.testing.assert_allclose(got.roi_feats.numpy(), np.asarray(want.roi_feats),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axes,self_tol", zip(MESHES, SELF_TOL))
def test_sp_predict_matches_jax_calibrated(calibrated, axes, self_tol):
    fx = calibrated
    got = fx["tdet"].predict_sharded(fx["images"], make_mesh(devices=["cpu"] * 8, **axes),
                                     conf_thres=CONF)
    want = fx["jdet"].predict_sharded(fx["images"], jax_make_mesh(**axes), conf_thres=CONF)
    assert int(np.asarray(want.det.valid).sum()) > 100
    assert_same(got, want, CROSS)
    one = fx["tdet"].predict(fx["images"], conf_thres=CONF)
    assert_same(got, one, self_tol)
    for a, b in zip(got.neck, one.neck):
        assert a.shape == b.shape and a.device == b.device
