"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Skipped where ``torch.cuda.is_available()`` is false (kernels build
with nvcc and run only on a CUDA device). On a machine with the card and no
JAX (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.ood import distance as D
from ood_in_object_detection_torch.ops import nms as N
from ood_in_object_detection_torch.ops import roi_align as R

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,k", [(8, 1024), (2, 189), (1, 4096)])
def test_nms_keep_kernel_matches_plain(dev, b, k):
    rng = np.random.default_rng(k)
    c = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(5, 200, (b, k, 2))
    cls = rng.integers(0, 3, (b, k))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + (cls * N.MAX_WH)[..., None]
    boxes = torch.tensor(boxes, dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.uniform(size=(b, k)) > 0.2, device=dev)
    before = N.greedy_keep.launches
    got = N.greedy_keep(boxes, valid, 0.7)
    assert N.greedy_keep.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, N.greedy_keep_plain(boxes, valid, 0.7))


@pytest.mark.parametrize("b,h,w,c,n2", [(8, 80, 80, 256, 600), (8, 40, 40, 512, 600),
                                        (2, 7, 9, 33, 5)])
def test_roi_contract_kernel_matches_plain(dev, b, h, w, c, n2):
    rng = np.random.default_rng(n2 + h)
    f = torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32, device=dev)
    wx = np.zeros((b, n2, w), np.float32)
    wy = np.zeros((b, n2, h), np.float32)
    for i in range(b):
        for n in range(n2):
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            x1, y1 = min(w, x0 + rng.integers(1, 20)), min(h, y0 + rng.integers(1, 20))
            wx[i, n, x0:x1] = rng.uniform(size=x1 - x0)
            wy[i, n, y0:y1] = rng.uniform(size=y1 - y0)
    wx, wy = torch.tensor(wx, device=dev), torch.tensor(wy, device=dev)
    got = R.roi_contract(f, wx, wy)
    torch.cuda.synchronize()
    ref = R.roi_contract_plain(f, wx, wy)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_roi_contract_kernel_rejects_bf16(dev):
    f = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(1, 2, 4, device=dev)
    with pytest.raises(NotImplementedError, match="bf16"):
        R.roi_contract(f, w, w)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("n,g,k,d", [(2400, 60, 1, 512), (37, 6, 5, 128)])
def test_min_group_distance_kernel_matches_plain(dev, metric, n, g, k, d):
    rng = np.random.default_rng(n + k)
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=dev)
    cents = torch.tensor(rng.normal(size=(g, k, d)), dtype=torch.float32, device=dev)
    if metric == "cosine":
        x, cents = D.l2_normalize_rows(x), D.l2_normalize_rows(cents)
    kmask = torch.tensor(rng.uniform(size=(g, k)) > 0.3, device=dev)
    kmask[0] = False
    got = D.min_group_distances(x, cents, kmask, metric)
    torch.cuda.synchronize()
    ref = D.min_group_distances_plain(x, cents, kmask, metric)
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    fin = torch.isfinite(ref)
    # l2: sqrt of a cancelled difference near 0 (see tests/test_torch_distance.py)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-5,
                               atol=1e-3 if metric == "l2" else 1e-5)
