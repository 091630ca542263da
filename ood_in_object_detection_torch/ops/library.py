"""Kernels K1, K2 and K4 as operators of the ``ood_torch`` namespace.

An operator is what lets ``torch.export`` record a kernel in a graph: the
tracer sees the operator's schema and its fake implementation (shapes and
dtypes only, no data pointer), and the graph, once run, dispatches on the
device of its inputs. One exported predict step thereby launches the kernels
on the card and runs their plain PyTorch versions on the CPU, the JAX
serving bundle's ``platforms=("cpu", "tpu")`` contract
(``utils/export.py``).

    nms_keep(boxes, valid, iou_thres) -> keep           K1, csrc/nms_keep.cu
    roi_contract(fmap, wx, wy) -> out                   K2, csrc/roi_contract.cu
    fused_stem(x, w1, <bn1>, w2, <bn2>, bf16) -> out    K4, csrc/fused_stem.cu

Each operator has three implementations:

- CUDA: the kernel's launch (:func:`nms_keep_cuda`, :func:`roi_contract_cuda`,
  :func:`fused_stem_cuda`, also called directly to time the dispatch). It
  raises on what the kernel does not take and never runs the plain version.
- CPU: the plain version (``greedy_keep_plain``, ``roi_contract_plain``,
  ``fused_stem_plain``), returning a fresh tensor.
- fake: the output's shape and dtype; it raises on the widths K4 does not
  take and on maps past ``K2_MAX_CELLS``, so an export fails at export time.

K4's operator takes the stem's weights and BatchNorm statistics unfolded:
its CPU implementation is ``fused_stem_plain``, which applies BatchNorm after
each convolution as the JAX model's phase-folded stem does, and its CUDA
implementation folds and packs them (``stem.k4_operands``) before the
launch, as the live wrapper always has. The operators are defined with
``torch.library.Library``: its dispatch costs the host a few microseconds a
call, ``torch.library.custom_op``'s several times more (PERF.md).

K3 (``ood/distance.py:min_group_distances``) stays a direct launch: it runs
in the OoD decisions, outside the exported step.
"""

from __future__ import annotations

import torch

from .nms import greedy_keep, greedy_keep_plain
from .roi_align import k2_check, k2_vector_path, roi_contract, roi_contract_plain
from .stem import check_k4_shapes, fused_stem_launch, fused_stem_plain, k4_operands

NAMESPACE = "ood_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("nms_keep(Tensor boxes, Tensor valid, float iou_thres) -> Tensor")
_LIB.define("roi_contract(Tensor fmap, Tensor wx, Tensor wy) -> Tensor")
_LIB.define("fused_stem(Tensor x, Tensor w1, Tensor bn1_scale, Tensor bn1_bias, "
            "Tensor bn1_mean, Tensor bn1_var, Tensor w2, Tensor bn2_scale, Tensor bn2_bias, "
            "Tensor bn2_mean, Tensor bn2_var, bool bf16) -> Tensor")


def _bn(scale, bias, mean, var) -> dict:
    return dict(scale=scale, bias=bias, mean=mean, var=var)


# ---- K1 ----

def nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Launch K1 on (B, k, 4) f32 boxes and (B, k) bool validity -> (B, k)
    bool; counts the launch in ``nms.greedy_keep.launches``."""
    from .kernels import _build

    _build.require_cuda("greedy_keep", boxes=boxes, valid=valid)
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"greedy_keep: needs f32 boxes and bool valid, got "
                        f"{boxes.dtype} and {valid.dtype}")
    b, k = valid.shape
    nw = (k + 63) // 64  # the scratch mask: k * k / 8 bytes an image
    mask = torch.empty((b, k, nw), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    code = _build.launcher("nms_keep")(
        boxes.data_ptr(), valid.data_ptr(), float(iou_thres), b, k,
        mask.data_ptr(), keep.data_ptr(), _build.stream_handle(boxes.device))
    _build.count_launch(greedy_keep, device=boxes.device.index)
    _build.check_launch("nms_keep", code)
    return keep


def _nms_keep_fake(boxes, valid, iou_thres):
    return torch.empty(valid.shape, dtype=torch.bool, device=valid.device)


# ---- K2 ----

def roi_contract_cuda(fmap: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Launch K2 on a (B, H, W, C) f32 or bf16 map -> (B, N2, C) f32;
    counts the launch in ``roi_align.roi_contract.launches`` (f32) or
    ``launches_bf16``."""
    from .kernels import _build

    _build.require_cuda("roi_contract", fmap=fmap, wx=wx, wy=wy)
    vec = k2_vector_path(fmap, wx, wy)
    b, h, w, c = fmap.shape
    n2 = wx.shape[1]
    bf16 = fmap.dtype == torch.bfloat16
    out = torch.empty((b, n2, c), dtype=torch.float32, device=fmap.device)
    code = _build.launcher("roi_contract")(
        fmap.data_ptr(), wx.data_ptr(), wy.data_ptr(), b, h, w, c, n2, int(bf16), int(vec),
        out.data_ptr(), _build.stream_handle(fmap.device))
    _build.count_launch(roi_contract, "launches_bf16" if bf16 else "launches",
                        fmap.device.index)
    _build.check_launch("roi_contract", code)
    return out


def _roi_contract_fake(fmap, wx, wy):
    k2_check(fmap, wx, wy)
    return fmap.new_empty((fmap.shape[0], wx.shape[1], fmap.shape[3]), dtype=torch.float32)


# ---- K4 ----

def fused_stem_cuda(x, w1, s1, b1, m1, v1, w2, s2, b2, m2, v2, bf16: bool) -> torch.Tensor:
    """Fold BatchNorm into K4's operands (``stem.k4_operands``) and launch
    K4 (``stem.fused_stem_launch``, which counts it) on a CUDA image
    (B, 3, H, W) -> (B, C2, H/4, W/4) in bf16 or f32."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    c2, c1 = w2.shape[:2]
    check_k4_shapes(x.shape, c1, c2)
    operands = k4_operands(w1, _bn(s1, b1, m1, v1), w2, _bn(s2, b2, m2, v2), dtype)
    return fused_stem_launch(x, operands, c1, c2, dtype)


def _fused_stem_cpu(x, w1, s1, b1, m1, v1, w2, s2, b2, m2, v2, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    return fused_stem_plain(x, w1, _bn(s1, b1, m1, v1), w2, _bn(s2, b2, m2, v2), dtype)


def _fused_stem_fake(x, w1, s1, b1, m1, v1, w2, s2, b2, m2, v2, bf16):
    c2, c1 = w2.shape[:2]
    check_k4_shapes(x.shape, c1, c2)
    b, _, h, w = x.shape
    return x.new_empty((b, c2, h // 4, w // 4),
                       dtype=torch.bfloat16 if bf16 else torch.float32)


for _name, _cuda, _cpu, _fake in (
        ("nms_keep", nms_keep_cuda, greedy_keep_plain, _nms_keep_fake),
        ("roi_contract", roi_contract_cuda, roi_contract_plain, _roi_contract_fake),
        ("fused_stem", fused_stem_cuda, _fused_stem_cpu, _fused_stem_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)

# the OpOverloads the wrappers call
nms_keep_op = torch.ops.ood_torch.nms_keep.default
roi_contract_op = torch.ops.ood_torch.roi_contract.default
fused_stem_op = torch.ops.ood_torch.fused_stem.default
