"""Serving bundles on the card: the ``ood_torch`` operators' CUDA
implementations inside an exported predict step. Skipped where
``torch.cuda.is_available()`` is false. On a machine with the card and no
JAX (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_export_cuda.py -q -m cuda

yolov8n at 64 px, nc 2, BatchNorm calibrated and head spread
(tests/test_torch_export.py), TF32 off. A bundle runs the live step's
operators in the same order on the same device, so on the card its output
is held bit for bit against the live detector's."""

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ops import library as L
from ood_in_object_detection_torch.ops import nms as N
from ood_in_object_detection_torch.ops import roi_align as R
from ood_in_object_detection_torch.ops import stem as S
from ood_in_object_detection_torch.utils import export as E
from test_torch_export import assert_outputs_equal, spread_detector

pytestmark = pytest.mark.cuda
IMG, CONF = 64, 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (S.fused_stem.launches, N.greedy_keep.launches, R.roi_contract.launches,
            R.roi_contract.launches_bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exported_on", ["cuda", "cpu"])
def test_bundle_on_the_card_matches_the_live_detector(dev, tmp_path, dtype, exported_on):
    """A bundle exported from the card's or the CPU's detector, served on
    the card: K4, K1 and K2 (K2b in bf16) launch once (K2 once a level)
    and the output is the live card detector's, bit for bit."""
    cpu = spread_detector(dtype=dtype)
    card = Detector(model=cpu.model.to(dev), img_size=IMG) if exported_on == "cuda" else \
        Detector(model=spread_detector(dtype=dtype).model.to(dev), img_size=IMG)
    source = card if exported_on == "cuda" else cpu
    p = E.export_serving_bundle(source, None, tmp_path / "b", batch=2, conf_thres=CONF)
    call, _, _ = E.load_serving_bundle(p)
    assert {b.device.type for b in call.parameters()} == {"cuda"}
    imgs = np.random.default_rng(1).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    x = torch.from_numpy(imgs).to(dev)
    before = _counts()
    with torch.no_grad():
        out = call(x)
    torch.cuda.synchronize()
    k2 = (0, 3) if dtype == torch.bfloat16 else (3, 0)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 1, *k2)
    live = card.predict(imgs, conf_thres=CONF)
    assert int(live.det.valid.sum()) > 10
    assert_outputs_equal(out, live)


def test_operators_launch_and_equal_their_direct_calls(dev):
    """Each operator on CUDA tensors is its CUDA implementation: the same
    output as the direct call, one launch counted each."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 500, (2, 300, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + rng.uniform(5, 80, (2, 300, 2))], -1),
                         dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.uniform(size=(2, 300)) < 0.8, device=dev)
    fmap = torch.randn((2, 20, 20, 64), device=dev)
    wx, wy = torch.rand((2, 40, 20), device=dev), torch.rand((2, 40, 20), device=dev)
    stem = [t.to(dev) if isinstance(t, torch.Tensor) else t
            for t in (torch.rand(2, 3, 32, 32), torch.randn(16, 3, 3, 3) * 0.3,
                      torch.rand(16) + 0.5, torch.randn(16) * 0.1, torch.randn(16) * 0.1,
                      torch.rand(16) + 0.5, torch.randn(32, 16, 3, 3) * 0.1,
                      torch.rand(32) + 0.5, torch.randn(32) * 0.1, torch.randn(32) * 0.1,
                      torch.rand(32) + 0.5, False)]
    for op, direct, args, counter in (
            (L.nms_keep_op, L.nms_keep_cuda, (boxes, valid, 0.7), 1),
            (L.roi_contract_op, L.roi_contract_cuda, (fmap, wx, wy), 2),
            (L.fused_stem_op, L.fused_stem_cuda, stem, 0)):
        before = _counts()
        got = op(*args)
        assert _counts()[counter] == before[counter] + 1
        assert torch.equal(got, direct(*args))
