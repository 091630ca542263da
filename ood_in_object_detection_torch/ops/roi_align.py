"""1x1 RoIAlign and the exact-position tap as one separable contraction per
level, and kernel K2's wrapper.

Port of ood_in_object_detection_tpu/ops/roi_align.py. Semantics: torchvision
roi_align with output_size=(1, 1), aligned=False, spatial_scale = map width /
image width (reference ultralytics/models/yolo/detect/predict.py:64-70),
adaptive ceil(span) sampling by default; the exact-position tap is the neck
feature at the box's own anchor cell (reference predict.py:288-325).

A uniform grid of bilinear taps is separable, so the pooled value is
``sum_h sum_w wy[h] * wx[w] * f[h, w, :]`` with per-axis weight vectors
(:func:`_axis_weights`, closed form for adaptive sampling). The exact tap is
the same sum with one-hot axis weights, so both ride one contraction per
level: :func:`roi_contract`, which calls the operator
``ood_torch::roi_contract`` (ops/library.py): it launches CUDA kernel K2
(``csrc/roi_contract.cu``) on CUDA tensors and runs
:func:`roi_contract_plain` on CPU tensors.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import library


def _clip(x, lo, hi):
    """jnp.clip order: minimum(maximum(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _axis_weights(lo: torch.Tensor, span: torch.Tensor, size: int, samples: int) -> torch.Tensor:
    """Mean-normalised bilinear weights of a uniform axis sample grid on the
    integer pixel grid -> (..., size). samples > 0: fixed S per axis;
    samples == 0: torchvision's adaptive S = ceil(span), in closed form."""
    if samples == 0:
        return _axis_weights_adaptive(lo, span, size)
    t = (torch.arange(samples, dtype=torch.float32, device=lo.device) + 0.5) / samples
    u = lo[..., None] + t * span[..., None]                          # (..., S)
    u = u.clamp(0.0, size - 1.0)
    p = torch.arange(size, dtype=torch.float32, device=lo.device)
    hat = torch.clamp(1.0 - torch.abs(u[..., None] - p), min=0.0)     # (..., S, size)
    return hat.sum(dim=-2) * (1.0 / samples)


def _axis_weights_adaptive(lo: torch.Tensor, span: torch.Tensor, size: int) -> torch.Tensor:
    """Exact adaptive axis weights in closed form -> (..., size).

    The S = ceil(span) sample coordinates u_s = lo + (s + 0.5) h, h = span/S,
    are an arithmetic sequence, so the summed hat weight of each cell is a
    window count plus arithmetic-series sums, with samples outside [0,
    size-1] clamped to the border cells (line for line the JAX function)."""
    zero = torch.zeros((), dtype=torch.float32, device=lo.device)
    n = torch.clamp(torch.ceil(span), min=1.0)
    h = (span / n)[..., None]
    lo_ = lo[..., None]
    n_ = n[..., None]
    p = torch.arange(size, dtype=torch.float32, device=lo.device)

    def idx(x):  # number of samples with u_s <= x, in [0, n]
        return _clip(torch.floor((x - lo_) / h - 0.5) + 1.0, zero, n_)

    n_left = idx(0.0)
    n_in = idx(size - 1.0)
    a1 = _clip(idx(p - 1.0), n_left, n_in)
    a2 = _clip(idx(p), n_left, n_in)
    a3 = _clip(idx(p + 1.0), n_left, n_in)

    def series(a, b):  # sum of u_s for s in [a, b)
        return (b - a) * lo_ + h * (b * b - a * a) * 0.5

    left = (a2 - a1) * (1.0 - p) + series(a1, a2)
    right = (a3 - a2) * (1.0 + p) - series(a2, a3)
    w = left + right
    w = w + torch.where(p == 0.0, n_left, zero)
    w = w + torch.where(p == size - 1.0, n_ - n_in, zero)
    return w / n_


def roi_contract_plain(fmap: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch contraction: (B, H, W, C), (B, N2, W), (B, N2, H) ->
    (B, N2, C) f32. Q = outer(wy, wx) is formed in f32 and rounded to the
    map dtype; Q and the map are then contracted in f32, so a bf16 map gets
    f32 sums of exact bf16 products (ops/pallas/roi.py's contract)."""
    b, h, w, c = fmap.shape
    n2 = wx.shape[1]
    q = (wy[..., :, None] * wx[..., None, :]).reshape(b, n2, h * w)
    q = q.to(fmap.dtype).float()
    return torch.einsum("bnk,bkc->bnc", q, fmap.reshape(b, h * w, c).float())


# the largest map K2 takes (H * W): its cell index splits into row and
# column by a float multiply, exact below this
K2_MAX_CELLS = 1 << 20


def k2_check(fmap: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> None:
    """Raise on what kernel K2 does not take: a map that is not f32 or bf16,
    axis weights that are not f32, a tensor that is not contiguous, a map
    past ``K2_MAX_CELLS``. Reads only dtypes, shapes and strides, so it runs
    on tensors of any device, fake ones included."""
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_contract: kernel K2 takes f32 or bf16 maps, got {fmap.dtype}")
    if wx.dtype != torch.float32 or wy.dtype != torch.float32:
        raise TypeError("roi_contract: axis weights must be f32")
    for name, t in (("fmap", fmap), ("wx", wx), ("wy", wy)):
        if not t.is_contiguous():
            raise ValueError(f"roi_contract: {name} must be contiguous")
    _, h, w, _ = fmap.shape
    if h * w > K2_MAX_CELLS:
        raise ValueError(f"roi_contract: kernel K2 takes maps of at most {K2_MAX_CELLS} cells, "
                         f"got {h}x{w}")


def k2_vector_path(fmap: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> bool:
    """Raise on what kernel K2 does not take (:func:`k2_check`); -> True for
    its 16-byte path (a lane loads 8 bf16 or 4 f32 channels at once), which
    needs a 16-byte aligned map and C a multiple of 8 (bf16) or 4 (f32),
    False for its scalar path (one channel per lane). Reads the map's
    address, so it needs a tensor with data."""
    k2_check(fmap, wx, wy)
    lanes = 8 if fmap.dtype == torch.bfloat16 else 4
    return fmap.data_ptr() % 16 == 0 and fmap.shape[3] % lanes == 0


def roi_contract(fmap: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """``out[b,n,c] = sum_h sum_w q(wy[b,n,h] wx[b,n,w]) fmap[b,h,w,c]`` with
    ``q`` the rounding to the map dtype: (B, H, W, C) f32 or bf16,
    (B, N2, W) f32, (B, N2, H) f32 -> (B, N2, C) f32.

    Replaces ops/pallas/roi.py:roi_matmul_level_two_stage (f32 maps) and
    roi_matmul_level_pallas's store / expand variants (bf16 maps). Calls the
    operator ``ood_torch::roi_contract`` (ops/library.py): CUDA tensors
    launch kernel K2 (csrc/roi_contract.cu) and count the launch in
    ``launches`` (f32) or ``launches_bf16`` (and per card index in
    ``launches_by_device``, ``launches_bf16_by_device``); CPU tensors take
    :func:`roi_contract_plain`."""
    if fmap.dim() != 4 or wx.dim() != 3 or wy.dim() != 3:
        raise ValueError("roi_contract: fmap (B,H,W,C), wx (B,N2,W), wy (B,N2,H)")
    b, h, w, _ = fmap.shape
    if wx.shape[0] != b or wx.shape[2] != w or wy.shape != (b, wx.shape[1], h):
        raise ValueError(f"roi_contract: shapes fmap {tuple(fmap.shape)}, wx "
                         f"{tuple(wx.shape)}, wy {tuple(wy.shape)} disagree")
    return library.roi_contract_op(fmap, wx, wy)


roi_contract.launches = 0
roi_contract.launches_bf16 = 0
roi_contract.launches_by_device = collections.Counter()
roi_contract.launches_bf16_by_device = collections.Counter()


def box_axis_weights(fmap_hw: Tuple[int, int], boxes_xyxy: torch.Tensor, spatial_scale: float,
                     samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """1x1 RoIAlign hat weights of boxes on an (H, W) map -> wx (..., W),
    wy (..., H); box sides are floored at one cell (torchvision,
    aligned=False)."""
    h, w = fmap_hw
    bx = boxes_xyxy * spatial_scale
    x1, y1 = bx[..., 0], bx[..., 1]
    bw = torch.clamp(bx[..., 2] - x1, min=1.0)
    bh = torch.clamp(bx[..., 3] - y1, min=1.0)
    return _axis_weights(x1, bw, w, samples), _axis_weights(y1, bh, h, samples)


def level_axis_weights(fmap_hw: Tuple[int, int], boxes_xyxy: torch.Tensor,
                       anchor_idx: torch.Tensor, level_idx: torch.Tensor, level: int,
                       offset: int, img_w: int, samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoI hat rows then exact-tap one-hot rows of one level ->
    wx (B, 2N, W), wy (B, 2N, H). Rows whose result this level does not
    supply (a box routed to another level; an anchor of another level) are
    zero, so the contraction skips them; their output is never selected."""
    h, w = fmap_hw
    wx, wy = box_axis_weights(fmap_hw, boxes_xyxy, w / img_w, samples)  # width ratio, predict.py:69
    local = torch.clamp(anchor_idx - offset, 0, h * w - 1)
    ex_wx = F.one_hot(local % w, w).to(torch.float32)
    ex_wy = F.one_hot(local // w, h).to(torch.float32)
    in_level = (anchor_idx >= offset) & (anchor_idx < offset + h * w)
    used = torch.cat([level_idx == level, in_level], dim=1)[..., None].to(torch.float32)
    return (torch.cat([wx, ex_wx], dim=1) * used, torch.cat([wy, ex_wy], dim=1) * used)


def roi_and_exact_batched(
    fmaps: Sequence[torch.Tensor],  # per level (B, H_l, W_l, C_l)
    boxes_xyxy: torch.Tensor,       # (B, N, 4) image pixels
    anchor_idx: torch.Tensor,       # (B, N) flat anchor index over all levels
    level_idx: torch.Tensor,        # (B, N) in [0, L)
    img_w: int,
    samples: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-routed 1x1 RoIAlign and exact-position tap -> two (B, N, Cmax)
    in the maps' dtype (the f32 contraction is rounded to it, as
    ops/roi_align.py:311 does), zero-padded to the widest level."""
    cmax = max(f.shape[-1] for f in fmaps)
    n = boxes_xyxy.shape[1]
    roi_out = exact_out = None
    off = 0
    for li, f in enumerate(fmaps):
        _, h, w, c = f.shape
        wx, wy = level_axis_weights((h, w), boxes_xyxy, anchor_idx, level_idx, li, off,
                                    img_w, samples)
        v = F.pad(roi_contract(f, wx, wy).to(f.dtype), (0, cmax - c))
        v_roi, v_ex = v[:, :n], v[:, n:]
        in_level = (anchor_idx >= off) & (anchor_idx < off + h * w)
        roi_out = v_roi if roi_out is None else torch.where(
            (level_idx == li)[..., None], v_roi, roi_out)
        exact_out = v_ex if exact_out is None else torch.where(
            in_level[..., None], v_ex, exact_out)
        off += h * w
    return roi_out, exact_out


def roi_align_1x1_batched_level(fmap: torch.Tensor, boxes_xyxy: torch.Tensor,
                                spatial_scale: float, samples: int = 0) -> torch.Tensor:
    """Single-level 1x1 RoIAlign of every box: (B, H, W, C), (B, N, 4) -> (B, N, C)."""
    wx, wy = box_axis_weights(fmap.shape[1:3], boxes_xyxy, spatial_scale, samples)
    return roi_contract(fmap, wx.contiguous(), wy.contiguous()).to(fmap.dtype)


def all_level_roi(fmaps: Sequence[torch.Tensor], boxes_xyxy: torch.Tensor,
                  img_w: int) -> List[torch.Tensor]:
    """Every box RoI-aligned at every level (adaptive sampling)."""
    return [roi_align_1x1_batched_level(f, boxes_xyxy, f.shape[2] / img_w, samples=0)
            for f in fmaps]
