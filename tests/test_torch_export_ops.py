"""The ``ood_torch`` operators (ops/library.py) on the CPU: K1, K2 and K4 as
operators with a CUDA, a CPU and a fake implementation.

- ``torch.library.opcheck`` (schema and fake-tensor checks) on the CPU
  implementations at small shapes, f32 and bf16;
- the fake implementations give the kernels' output shapes and dtypes and
  raise on what the kernels refuse (K4's C1 / C2 range, maps past
  ``K2_MAX_CELLS``), while the CPU implementations serve those shapes;
- the CUDA implementations raise on CPU tensors: they never run the plain
  versions;
- the public wrappers reach the operators on the CPU;
- ``DistanceOODMethod.__getstate__``: a method that has decided pickles
  without its device banks and unpickles to the same decisions;
- the import walk of tests/test_torch_import.py covers the new modules."""

import pickle
import pkgutil

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import ood_in_object_detection_torch as P
from ood_in_object_detection_torch.ood.methods import DistanceOODMethod
from ood_in_object_detection_torch.ops import library as L
from ood_in_object_detection_torch.ops import nms as N
from ood_in_object_detection_torch.ops import roi_align as R
from ood_in_object_detection_torch.ops import stem as S
from torch_threads import _two_threads  # noqa: F401 (autouse)


def _stem_args(c1, c2, b=2, h=16, w=24, bf16=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, 3, h, w), generator=g)
    w1 = torch.randn((c1, 3, 3, 3), generator=g) * 0.3
    w2 = torch.randn((c2, c1, 3, 3), generator=g) * 0.1

    def bn(c):
        return [torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.1,
                torch.randn(c, generator=g) * 0.1, torch.rand(c, generator=g) + 0.5]

    return (x, w1, *bn(c1), w2, *bn(c2), bf16)


def _nms_args(b=2, k=40, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (b, k, 2))], -1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(rng.uniform(size=(b, k)) < 0.8), 0.5


def _roi_args(dtype=torch.float32, b=2, n2=6, h=8, w=12, c=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, h, w, c), generator=g).to(dtype),
            torch.rand((b, n2, w), generator=g), torch.rand((b, n2, h), generator=g))


OPCHECK_CASES = {
    "nms_keep": (L.nms_keep_op, _nms_args),
    "roi_contract_f32": (L.roi_contract_op, _roi_args),
    "roi_contract_bf16": (L.roi_contract_op, lambda: _roi_args(torch.bfloat16)),
    "fused_stem_f32": (L.fused_stem_op, lambda: _stem_args(16, 32)),
    "fused_stem_bf16": (L.fused_stem_op, lambda: _stem_args(16, 32, bf16=True)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck_cpu(case):
    """Schema (no mutation, no aliasing of an input) and fake-tensor
    (the fake's shapes, dtypes and strides are the CPU result's) checks."""
    op, make = OPCHECK_CASES[case]
    result = torch.library.opcheck(op, make(), test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("c1,c2", [(8, 32), (104, 128), (16, 24), (16, 200), (20, 40)])
def test_fake_refuses_k4_widths(c1, c2):
    """Widths outside K4's C1 [16, 96] / C2 [32, 192] multiples of 8 raise
    in the fake (an export fails there); the CPU runs the plain version."""
    args = _stem_args(c1, c2, b=1, h=8, w=8)
    assert L.fused_stem_op(*args).shape == (1, c2, 2, 2)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with pytest.raises(ValueError, match="K4 takes C1"):
            L.fused_stem_op(*fake)


def test_fake_refuses_k4_image_shape():
    args = list(_stem_args(16, 32, b=1, h=8, w=8))
    args[0] = torch.rand(1, 4, 8, 8)  # K4 reads 3 channels
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with pytest.raises(ValueError, match="K4 takes"):
            L.fused_stem_op(*fake)


@pytest.mark.parametrize("h,w,refused", [(1024, 1024, False), (1025, 1024, True),
                                         (2048, 1024, True)])
def test_fake_refuses_k2_cells(h, w, refused):
    """A map past K2_MAX_CELLS (2^20) raises in the fake; one at the limit
    does not (fake tensors allocate nothing)."""
    with FakeTensorMode():
        fmap = torch.empty((1, h, w, 8))
        wx, wy = torch.empty((1, 4, w)), torch.empty((1, 4, h))
        if refused:
            with pytest.raises(ValueError, match="at most 1048576 cells"):
                L.roi_contract_op(fmap, wx, wy)
        else:
            assert L.roi_contract_op(fmap, wx, wy).shape == (1, 4, 8)


def test_export_fails_at_export_time_on_refused_widths():
    """torch.export of a step K4 does not take raises while tracing."""
    args = _stem_args(8, 32, b=1, h=8, w=8)

    class Stem(torch.nn.Module):
        def forward(self, x):
            return L.fused_stem_op(x, *args[1:])

    with pytest.raises(ValueError, match="K4 takes C1"):
        torch.export.export(Stem(), (args[0],))


@pytest.mark.parametrize("name", ["nms", "roi", "stem"])
def test_cuda_implementations_refuse_cpu_tensors(name):
    """The CUDA implementations launch or raise: on CPU tensors they raise
    and never run the plain version."""
    fn, args = {"nms": (L.nms_keep_cuda, _nms_args()),
                "roi": (L.roi_contract_cuda, _roi_args()),
                "stem": (L.fused_stem_cuda, _stem_args(16, 32))}[name]
    with pytest.raises(ValueError, match="needs CUDA"):
        fn(*args)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_wrappers_reach_the_operators():
    """greedy_keep, roi_contract and fused_stem dispatch ``ood_torch``
    operators on the CPU and return the plain versions' values."""
    from ood_in_object_detection_torch.models.layers import Conv

    boxes, valid, iou = _nms_args()
    fmap, wx, wy = _roi_args()
    torch.manual_seed(0)
    conv0, conv1 = Conv(3, 16, 3, 2).eval(), Conv(16, 32, 3, 2).eval()
    x = torch.rand(2, 3, 16, 16)
    with torch.no_grad(), _Ops() as ops:
        keep = N.greedy_keep(boxes, valid, iou)
        out = R.roi_contract(fmap, wx, wy)
        y = S.fused_stem(x, conv0, conv1, torch.float32)
    assert [s for s in ops.seen if s.startswith("ood_torch.")] == [
        "ood_torch.nms_keep.default", "ood_torch.roi_contract.default",
        "ood_torch.fused_stem.default"]
    assert torch.equal(keep, N.greedy_keep_plain(boxes, valid, iou))
    assert torch.equal(out, R.roi_contract_plain(fmap, wx, wy))
    with torch.no_grad():
        want = S.fused_stem_plain(x, *S.stem_conv_params(conv0, conv1), torch.float32)
    assert torch.equal(y, want)


def test_distance_method_pickles_without_banks():
    """A Cosine method that has decided (its bank built on the deciding
    device) pickles with no tensor in it and decides the same after."""
    rng = np.random.default_rng(3)
    m = DistanceOODMethod.from_name("Cosine_cl_stride")
    m.clusters = [[rng.normal(size=(2, 8)).astype(np.float32) for _ in range(3)]
                  for _ in range(2)]
    m.thresholds = [[0.6, 0.7, 0.8], [0.9, 0.5, 0.7]]
    feats = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    feats = feats / feats.norm(dim=1, keepdim=True)
    cls = torch.from_numpy(rng.integers(0, 2, 40))
    level = torch.from_numpy(rng.integers(0, 3, 40))
    before = m.decide_from_distances(m.distances(feats, cls, level), cls, level,
                                     torch.ones(40, dtype=torch.bool))
    assert m._banks, "deciding builds the bank"
    data = pickle.dumps(m)
    assert b"_rebuild_tensor" not in data and b"torch._utils" not in data
    m2 = pickle.loads(data)
    assert m2._banks == {} and m._banks
    after = m2.decide_from_distances(m2.distances(feats, cls, level), cls, level,
                                     torch.ones(40, dtype=torch.bool))
    assert torch.equal(before, after) and 0 < int(after.sum()) < 40
    assert m2._banks


def test_import_walk_covers_the_export_modules():
    """tests/test_torch_import.py walks ops and utils: both new modules are
    in its walk."""
    names = {m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")}
    assert {"ood_in_object_detection_torch.ops.library",
            "ood_in_object_detection_torch.utils.export"} <= names
