"""yolo11 in the port (models/layers.py C3, C3k, C3k2, Attention, PSABlock,
C2PSA; the v11 head) against the JAX package on the CPU.

Each layer class alone, on one seeded input with seeded weights away from
identity (tests/test_torch_zoo.py:layer_parity), in f32 and bf16 within
LAYER_TOL. The whole forward at 64 px in f32, raw maps and neck taps, at
yolo11n and at yolo11m (c3k_force: every C3k2 takes C3k blocks), within
1e-4 of each map's largest magnitude (the tolerance of
tests/test_torch_model.py). The BatchNorm statistics are calibrated on the
compared images: on other noise a random network's activations grow layer
after layer, and the f32 summation-order difference with them."""

import functools

import numpy as np
import pytest

from ood_in_object_detection_tpu.models import layers as JL
from ood_in_object_detection_torch.models import layers as TL
from test_torch_zoo import DTYPES, IMG, assert_forward_matches, assert_layer_matches, zoo_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

# name -> (JAX partial without dtype, port layer factory, input NHWC shape)
LAYERS = {
    "C3k2": (functools.partial(JL.C3k2, 48, 2), lambda: TL.C3k2(32, 48, 2), (2, 8, 8, 32)),
    "C3k2_c3k": (functools.partial(JL.C3k2, 48, 2, c3k=True),
                 lambda: TL.C3k2(32, 48, 2, c3k=True), (2, 8, 8, 32)),
    "C3k2_e025": (functools.partial(JL.C3k2, 64, 1, e=0.25),
                  lambda: TL.C3k2(32, 64, 1, e=0.25), (2, 8, 8, 32)),
    "C3k": (functools.partial(JL.C3k, 32, 2), lambda: TL.C3k(32, 32, 2), (2, 8, 8, 32)),
    "Attention": (functools.partial(JL.Attention, 128, 2), lambda: TL.Attention(128, 2),
                  (2, 6, 5, 128)),
    "PSABlock": (functools.partial(JL.PSABlock, 128, 0.5, 2), lambda: TL.PSABlock(128, 0.5, 2),
                 (2, 4, 4, 128)),
    "C2PSA": (functools.partial(JL.C2PSA, 256, 2), lambda: TL.C2PSA(256, 256, 2),
              (2, 4, 4, 256)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_jax(layer, dtype):
    assert_layer_matches(LAYERS[layer], dtype)


@pytest.mark.parametrize("name", ["yolo11n", "yolo11m"])
def test_forward_matches_jax(name):
    x = np.random.default_rng(7).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jm, variables, tm = zoo_weights(name, nc=2, calib=x)
    assert tm.stem_route == "fused"
    assert_forward_matches(jm, variables, tm, x)
