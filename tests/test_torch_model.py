"""Port parity of the YOLOv8 forward (models/{layers,head,yolo}.py) against
the JAX package, on the CPU at 96 px, with weights carried across through
``export_state_dict`` -> ``load_jax_variables`` (strict) and back through
``import_state_dict`` (strict).

A random init with identity BatchNorm shrinks activations towards zero with
depth, which would make any comparison vacuous; so the shared weights get
their BatchNorm statistics calibrated on a seeded batch and a seeded spread
of the head's output convs first (utils/weights.py). Tolerance: rtol 1e-4
and atol 1e-4 of each tensor's largest magnitude. The f32 convolutions sum
in another order than XLA's over up to ~60 layers, and the measured worst
case is 2.6e-5 of the largest magnitude (yolov8l, P4 raw map)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.utils.weight_import import export_state_dict, import_state_dict
from ood_in_object_detection_torch.models import build_model
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG = 96


@functools.lru_cache(maxsize=None)
def _jax_init(name: str, nc: int):
    """-> (jax model, its init jitted once a process): bit-equal to the
    eager init, which compiles each op on its first call (~50 s for
    yolov8n on the CPU against ~15 s for one compile)."""
    jm = jax_build_model(name, nc=nc)
    return jm, jax.jit(lambda key, x: jm.init(key, x, train=False))


def shared_weights(name: str, nc: int, seed: int = 0, calib=None, spread: float = 4.0,
                   bn_scale: float = 1.0):
    """-> (jax model, jax variables, torch model) holding the same weights:
    the JAX init exported and loaded into torch, BN-calibrated on ``calib``
    (NCHW floats; seeded uniform noise by default) and head-spread there
    (``spread``: utils/weights.py spread_detect_head's scale), then imported
    back into the JAX variables. ``bn_scale`` sets every BatchNorm's scale
    before the calibration, so that each Conv block leaves activations of
    that standard deviation."""
    jm, init = _jax_init(name, nc)
    variables = init(jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 3)))
    tm = build_model(name, nc=nc)
    load_jax_variables(tm, export_state_dict(variables, detect_layer_idx=tm.detect_layer_idx))
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.constant_(m.weight, bn_scale)
    if calib is None:
        calib = torch.from_numpy(
            np.random.default_rng(seed).uniform(0, 1, (4, 3, IMG, IMG)).astype(np.float32))
    calibrate_batchnorm(tm, calib)
    sd = spread_detect_head(numpy_state_dict(tm), seed=seed + 1, scale=spread)
    load_jax_variables(tm, sd)
    variables, missing = import_state_dict(variables, sd, detect_layer_idx=tm.detect_layer_idx,
                                           strict=True)
    assert not missing
    return jm, variables, tm.eval()


@pytest.fixture(scope="module", params=["yolov8n", "yolov8l"])
def models(request):
    return shared_weights(request.param, nc=2)


def test_forward_matches_jax(models):
    jm, variables, tm = models
    x = np.random.default_rng(7).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    raw_j, neck_j = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        raw_t, neck_t = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for j, t in list(zip(raw_j, raw_t)) + list(zip(neck_j, neck_t)):
        t = t.permute(0, 2, 3, 1).numpy()
        j = np.asarray(j)
        assert t.std() > 0.1, "activations collapsed: the comparison would be vacuous"
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_neck_channels_match_jax(models):
    jm, variables, tm = models
    shapes = jax.eval_shape(lambda v: jm.apply(v, jnp.zeros((1, IMG, IMG, 3)), train=False),
                            variables)[1]
    assert tuple(tm.neck_channels) == tuple(f.shape[-1] for f in shapes)


def test_state_dict_keys_are_ultralytics_names(models):
    _, variables, tm = models
    assert set(tm.state_dict()) == set(export_state_dict(variables,
                                                         detect_layer_idx=tm.detect_layer_idx))


def test_detector_create_defaults_to_the_card():
    """Detector.create builds on the card unless asked for the CPU; without
    CUDA it raises and names device="cpu"."""
    from ood_in_object_detection_torch.engine import Detector

    if torch.cuda.is_available():
        assert Detector.create("yolov8n", nc=2, img_size=96).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Detector.create("yolov8n", nc=2, img_size=96)
    det = Detector.create("yolov8n", nc=2, img_size=96, device="cpu", dtype=torch.bfloat16)
    assert det.device.type == "cpu" and det.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in det.model.parameters())
