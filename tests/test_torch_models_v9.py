"""yolov9 in the port (models/layers.py RepConvN, RepBottleneck, RepCSP,
RepNCSPELAN4, ELAN1, ADown, AConv, SPPELAN, CBLinear, CBFuse) against the
JAX package on the CPU, with the tolerances and fixtures of
tests/test_torch_models_v11.py: each layer class alone in f32 and bf16
(CBLinear and CBFuse are steps of the JAX model, not layer classes: yolov9e's
forward holds them), and the whole forward at 64 px in f32 at yolov9t
(ELAN1, AConv) and yolov9e (ADown, CBLinear / CBFuse, the stem run as two
Conv modules)."""

import functools

import numpy as np
import pytest

from ood_in_object_detection_tpu.models import layers as JL
from ood_in_object_detection_torch.models import layers as TL
from test_torch_zoo import DTYPES, IMG, assert_forward_matches, assert_layer_matches, zoo_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

LAYERS = {
    "RepConvN": (functools.partial(JL.RepConvDW, 48), lambda: TL.RepConvN(32, 48),
                 (2, 8, 8, 32)),
    "RepBottleneck": (functools.partial(JL.RepBottleneck, 32, True, e=1.0),
                      lambda: TL.RepBottleneck(32, 32, True, e=1.0), (2, 8, 8, 32)),
    "RepCSP": (functools.partial(JL.RepCSP, 48, 2), lambda: TL.RepCSP(32, 48, 2), (2, 8, 8, 32)),
    "RepNCSPELAN4": (functools.partial(JL.RepNCSPELAN4, 64, 64, 36, 1),
                     lambda: TL.RepNCSPELAN4(32, 64, 64, 36, 1), (2, 8, 8, 32)),
    "ELAN1": (functools.partial(JL.ELAN1, 64, 48, 24), lambda: TL.ELAN1(32, 64, 48, 24),
              (2, 8, 8, 32)),
    "ADown": (functools.partial(JL.ADown, 48), lambda: TL.ADown(32, 48), (2, 9, 8, 32)),
    "AConv": (functools.partial(JL.AConv, 48), lambda: TL.AConv(32, 48), (2, 8, 9, 32)),
    "SPPELAN": (functools.partial(JL.SPPELAN, 64, 24), lambda: TL.SPPELAN(32, 64, 24),
                (2, 8, 8, 32)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_jax(layer, dtype):
    assert_layer_matches(LAYERS[layer], dtype)


@pytest.mark.parametrize("name", ["yolov9t", "yolov9e"])
def test_forward_matches_jax(name):
    x = np.random.default_rng(7).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jm, variables, tm = zoo_weights(name, nc=2, calib=x)
    assert tm.stem_route == ("conv" if name == "yolov9e" else "fused")
    assert_forward_matches(jm, variables, tm, x)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_avg_pool_rounds_as_flax(dtype):
    """ADown's and AConv's 2x2/s1 average pool against flax's: in bf16 bit
    for bit (XLA adds the window row-major, each partial sum rounded to
    bf16), in f32 within one f32 rounding of a sum of four (XLA's f32 sum
    order is its own)."""
    import jax.numpy as jnp
    import torch
    from flax import linen as fnn

    tdt, jdt = DTYPES[dtype]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 16, 9, 8)).astype(np.float32))
    x = x.to(tdt)
    want = fnn.avg_pool(jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jdt), (2, 2),
                        strides=(1, 1), padding="VALID")
    got = TL.avg_pool2(x)
    assert got.dtype == tdt
    got, want = got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32)
    if dtype == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -24 * np.abs(x.numpy()).max())
