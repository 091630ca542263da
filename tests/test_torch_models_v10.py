"""yolov10 in the port (models/layers.py SCDown, RepVGGDW, CIB, C2fCIB,
PSA; the v10 dual head) against the JAX package on the CPU, with the
tolerances and fixtures of tests/test_torch_models_v11.py: each layer
class alone in f32 and bf16, and the whole forward at 64 px in f32 at
yolov10n and at yolov10s (whose C2fCIB blocks take RepVGGDW, ``lk``),
one2one maps first, neck taps, then the one2many maps (built by the head's
training form: the eval forward runs only the one2one branches, which
``test_eval_forward_skips_one2many`` holds)."""

import functools

import numpy as np
import pytest
import torch

from ood_in_object_detection_tpu.models import layers as JL
from ood_in_object_detection_torch.models import build_model
from ood_in_object_detection_torch.models import layers as TL
from test_torch_zoo import DTYPES, IMG, assert_forward_matches, assert_layer_matches, zoo_weights
from torch_threads import _two_threads  # noqa: F401 (autouse)

LAYERS = {
    "SCDown": (functools.partial(JL.SCDown, 48, 3, 2), lambda: TL.SCDown(32, 48, 3, 2),
               (2, 8, 8, 32)),
    "RepVGGDW": (functools.partial(JL.RepVGGDW, 32), lambda: TL.RepVGGDW(32), (2, 8, 8, 32)),
    "CIB": (functools.partial(JL.CIB, 32, True, 1.0), lambda: TL.CIB(32, 32, True, 1.0),
            (2, 8, 8, 32)),
    "CIB_lk": (functools.partial(JL.CIB, 32, True, 0.5, lk=True),
               lambda: TL.CIB(32, 32, True, 0.5, lk=True), (2, 8, 8, 32)),
    "CIB_no_shortcut": (functools.partial(JL.CIB, 48, False, 1.0),
                        lambda: TL.CIB(32, 48, False, 1.0), (2, 8, 8, 32)),
    "C2fCIB": (functools.partial(JL.C2fCIB, 64, 2, True), lambda: TL.C2fCIB(32, 64, 2, True),
               (2, 8, 8, 32)),
    "C2fCIB_lk": (functools.partial(JL.C2fCIB, 64, 1, True, lk=True),
                  lambda: TL.C2fCIB(32, 64, 1, True, lk=True), (2, 8, 8, 32)),
    "PSA": (functools.partial(JL.PSA, 256), lambda: TL.PSA(256, 256), (2, 4, 4, 256)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_jax(layer, dtype):
    assert_layer_matches(LAYERS[layer], dtype)


@pytest.mark.parametrize("name", ["yolov10n", "yolov10s"])
def test_forward_matches_jax(name):
    x = np.random.default_rng(7).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jm, variables, tm = zoo_weights(name, nc=2, calib=x)
    assert tm.stem_route == "fused" and tm.model[-1].dual
    assert_forward_matches(jm, variables, tm, x)


def test_eval_forward_skips_one2many():
    """In eval the dual head runs its one2one branches alone and the model
    returns (one2one maps, neck taps); in training it returns the one2many
    maps third, as the JAX model does."""
    tm = build_model("yolov10n", nc=2).eval()
    head = tm.model[-1]
    calls = {"one2many": 0, "one2one": 0}

    def count(key):
        def hook(*_):
            calls[key] += 1
        return hook

    for key, mods in (("one2many", (head.cv2, head.cv3)),
                      ("one2one", (head.one2one_cv2, head.one2one_cv3))):
        for ml in mods:
            for seq in ml:  # the forward calls a branch's modules one by one
                seq[0].register_forward_hook(count(key))
    x = torch.rand(1, 3, IMG, IMG)
    with torch.no_grad():
        out = tm(x)
    assert len(out) == 2 and calls == {"one2many": 0, "one2one": 6}
    tm.train()
    with torch.no_grad():
        raw, neck, raw_main = tm(x)
    assert calls == {"one2many": 6, "one2one": 12}
    assert [r.shape for r in raw] == [r.shape for r in raw_main]
