"""yolo12 in the port (models/layers.py AAttn, ABlock, A2C2f; a v11 head)
against the JAX package on the CPU, with the tolerances and fixtures of
tests/test_torch_models_v11.py: each layer class alone in f32 and bf16
(AAttn with area 1 and 4, A2C2f with the gamma residual, with ABlocks and
with C3k blocks), and the whole forward at 64 px in f32 at yolo12n and at
yolo12l (c3k_force, the gamma residual and MLP ratio 1.2). On noise other
than the calibration images a random yolo12l's gamma residuals add
unnormalised sums, its P5 activations reach ~1e4 and the f32 difference
1.8e-4 of the map, while each layer alone agrees to 1.3e-5 or better."""

import functools

import numpy as np
import pytest

from ood_in_object_detection_tpu.models import layers as JL
from ood_in_object_detection_torch.models import layers as TL
from test_torch_zoo import DTYPES, IMG, assert_forward_matches, assert_layer_matches, zoo_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

# name -> (JAX partial without dtype, port layer factory, input NHWC shape)
LAYERS = {
    "AAttn_area1": (functools.partial(JL.AAttn, 64, 2, 1), lambda: TL.AAttn(64, 2, 1),
                    (2, 6, 4, 64)),
    "AAttn_area4": (functools.partial(JL.AAttn, 64, 2, 4), lambda: TL.AAttn(64, 2, 4),
                    (2, 8, 6, 64)),
    "ABlock": (functools.partial(JL.ABlock, 64, 2, 1.2, 4), lambda: TL.ABlock(64, 2, 1.2, 4),
               (2, 4, 4, 64)),
    "A2C2f_gamma": (functools.partial(JL.A2C2f, 128, 2, a2=True, area=4, residual=True,
                                      mlp_ratio=1.2),
                    lambda: TL.A2C2f(128, 128, 2, True, 4, residual=True, mlp_ratio=1.2),
                    (2, 4, 4, 128)),
    "A2C2f": (functools.partial(JL.A2C2f, 128, 1, a2=True, area=1),
              lambda: TL.A2C2f(96, 128, 1, True, 1), (2, 4, 4, 96)),
    "A2C2f_c3k": (functools.partial(JL.A2C2f, 64, 2, a2=False),
                  lambda: TL.A2C2f(48, 64, 2, False), (2, 4, 4, 48)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_jax(layer, dtype):
    assert_layer_matches(LAYERS[layer], dtype)


@pytest.mark.parametrize("name", ["yolo12n", "yolo12l"])
def test_forward_matches_jax(name):
    x = np.random.default_rng(7).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jm, variables, tm = zoo_weights(name, nc=2, calib=x)
    assert tm.stem_route == "fused"
    assert_forward_matches(jm, variables, tm, x)
