"""Batched EUL front end on the map's device: saliency summarization,
histogram thresholds and the threshold compare for the whole batch.

Port of ood_in_object_detection_tpu/ood/unknown_device.py. Semantics, not
the TPU form:

- every summarizer is a per-pixel channel reduction; the ``*minus_mean*`` and
  ``*_absolute_deviation`` ones subtract the mean over the unpadded crop, so
  the batch uses a padding mask and a masked mean (values outside the crop
  are cropped away on the host);
- Otsu is weighted Otsu: the recursive split tree (reference
  unknown_localization_utils.py:175-200) unrolled over its static depth,
  each node a {0, 1} weight over the flat saliency; a degenerate node (empty
  or constant) gives NaN and empties its subtree;
- quantile thresholds are a masked sort and linear interpolation.

jnp's conventions are kept where torch's differ: the median and the
percentiles interpolate linearly (``torch.median`` would return the lower
middle value of C = 256), the standard deviation is ddof 0 in two passes, and the
histogram bins as ``floor((v - lo) / span * 256)`` clipped to [0, 255].
Everything is f32 (a bf16 map is upcast first). The masks stay bool: the
JAX package packs them into bits only to cross a slow host link.
"""

from __future__ import annotations

import torch

NBINS = 256  # host threshold_otsu / np.histogram default used in unknown.py

DEVICE_SUMMARIZERS = frozenset({
    "ftmap_minus_mean_of_ftmaps_then_abs_sum",
    "ftmap_minus_mean_of_ftmaps_then_sum",
    "sum_of_ftmaps",
    "std_of_ftmaps",
    "iqr_of_ftmaps",
    "mean_absolute_deviation_of_ftmaps",
    "median_absolute_deviation_of_ftmaps",
})
DEVICE_THRESHOLDERS = frozenset({"recursive_otsu", "quantile"})


def _grid_mask(pad_xy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 2) int (px, py) letterbox pads in stride-8 cells -> (B, H, W)
    bool mask of the unpadded crop ``[py : H - py, px : W - px]``."""
    px = pad_xy[:, 0][:, None, None]
    py = pad_xy[:, 1][:, None, None]
    ys = torch.arange(H, device=pad_xy.device)[None, :, None]
    xs = torch.arange(W, device=pad_xy.device)[None, None, :]
    return (ys >= py) & (ys < H - py) & (xs >= px) & (xs < W - px)


def _quantile_last(x: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile(x, q, axis=-1), linear interpolation between the sorted
    values at floor and ceil of q * (n - 1)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    pos = q * (n - 1)
    lo, hi = int(pos // 1), min(int(-(-pos // 1)), n - 1)
    frac = pos - lo
    return s[..., lo] * (1.0 - frac) + s[..., hi] * frac


def _summarize(f: torch.Tensor, mask: torch.Tensor, name: str) -> torch.Tensor:
    """(B, H, W, C) f32 -> (B, H, W) saliency; the mean-subtracting
    summarizers use the masked (crop) mean."""
    m3 = mask[..., None].to(f.dtype)
    cnt = torch.clamp(m3.sum(dim=(1, 2)), min=1.0)            # (B, 1)
    mean = ((f * m3).sum(dim=(1, 2)) / cnt)[:, None, None, :]
    if name == "ftmap_minus_mean_of_ftmaps_then_abs_sum":
        return torch.abs(f - mean).sum(-1)
    if name == "ftmap_minus_mean_of_ftmaps_then_sum":
        return (f - mean).sum(-1)
    if name == "sum_of_ftmaps":
        return f.sum(-1)
    if name == "std_of_ftmaps":  # jnp.std: ddof 0, two passes
        return torch.sqrt(((f - f.mean(-1, keepdim=True)) ** 2).mean(-1))
    if name == "iqr_of_ftmaps":
        return _quantile_last(f, 0.75) - _quantile_last(f, 0.25)
    if name == "mean_absolute_deviation_of_ftmaps":
        return torch.abs(f - mean).mean(-1)
    if name == "median_absolute_deviation_of_ftmaps":
        y = f - mean
        med = _quantile_last(y, 0.5)[..., None]
        return _quantile_last(torch.abs(y - med), 0.5)
    raise ValueError(f"no device summarizer: {name}")


def _otsu_weighted(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 256-bin Otsu of each row of ``vals`` (B, P) f32 with {0, 1}
    weights -> (B,) thresholds.

    The host ``threshold_otsu``'s definition (maximize the inter-class
    variance, return the left bin's center) with np.histogram's binning:
    edges linspace(lo, hi, NBINS + 1), right edge inclusive. NaN where the
    weighted subset is empty or constant (the host recursion's stop)."""
    out = w <= 0
    lo = vals.masked_fill(out, float("inf")).amin(dim=1)
    hi = vals.masked_fill(out, -float("inf")).amax(dim=1)
    n = w.sum(dim=1)
    span = hi - lo
    safe = torch.where(span > 0, span, torch.ones_like(span))
    idx = torch.floor((vals - lo[:, None]) / safe[:, None] * NBINS).clamp(0, NBINS - 1).long()
    counts = torch.zeros((vals.shape[0], NBINS), dtype=torch.float32, device=vals.device)
    counts.scatter_add_(1, idx, w)
    steps = torch.arange(NBINS + 1, dtype=torch.float32, device=vals.device)
    edges = lo[:, None] + span[:, None] * steps / NBINS
    centers = (edges[:, :-1] + edges[:, 1:]) * 0.5
    w1 = torch.cumsum(counts, dim=1)
    w2 = torch.cumsum(counts.flip(1), dim=1).flip(1)
    m1 = torch.cumsum(counts * centers, dim=1) / torch.clamp(w1, min=1e-12)
    m2 = (torch.cumsum((counts * centers).flip(1), dim=1)
          / torch.clamp(w2.flip(1), min=1e-12)).flip(1)
    var12 = w1[:, :-1] * w2[:, 1:] * (m1[:, :-1] - m2[:, 1:]) ** 2
    t = torch.gather(centers[:, :-1], 1, var12.argmax(dim=1, keepdim=True))[:, 0]
    return torch.where((n > 0) & (span > 0), t, torch.full_like(t, float("nan")))


def _recursive_otsu(vals: torch.Tensor, mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The recursive-Otsu tree unrolled (host ``recursive_otsu``): depth d in
    [1, num_classes - 2] has 2^(d-1) nodes; each thresholds its weighted
    subset and splits it <= t / > t. -> (B, 2^(num_classes-2) - 1) node
    thresholds in tree order, NaN for degenerate nodes."""
    thrs = []
    nodes = [mask.to(torch.float32)]
    for _depth in range(1, max(num_classes - 1, 1)):
        nxt = []
        for w in nodes:
            t = _otsu_weighted(vals, w)
            thrs.append(t)
            ok = torch.isfinite(t)
            tt = torch.where(ok, t, torch.zeros_like(t))[:, None]
            okf = ok.to(torch.float32)[:, None]
            nxt.append(w * (vals <= tt).to(torch.float32) * okf)
            nxt.append(w * (vals > tt).to(torch.float32) * okf)
        nodes = nxt
    if not thrs:
        return torch.full((vals.shape[0], 1), float("nan"), device=vals.device)
    return torch.stack(thrs, dim=1)


def _quantile_thresholds(vals: torch.Tensor, mask: torch.Tensor,
                         num_quantiles: int) -> torch.Tensor:
    """Masked np.quantile('linear') of the interior quantiles (host
    ``quantile_thresholding``): sort with masked values pushed to +inf, then
    interpolate at q * (n - 1) over the n valid leading entries -> (B, Q)."""
    qs = torch.linspace(0.0, 1.0, num_quantiles + 1, device=vals.device)[1:-1]
    n = mask.sum(dim=1).to(torch.float32)
    s = torch.sort(torch.where(mask, vals, torch.full_like(vals, float("inf"))), dim=1).values
    pos = qs[None, :] * torch.clamp(n - 1.0, min=0.0)[:, None]
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo.to(torch.float32)
    out = torch.gather(s, 1, lo) * (1.0 - frac) + torch.gather(s, 1, hi) * frac
    return torch.where((n > 0)[:, None], out, torch.full_like(out, float("nan")))


def eul_frontend(p3: torch.Tensor, pad_xy: torch.Tensor, *, summarizer: str, method: str,
                 num_thresholds: int):
    """Batched EUL front end (saliency + thresholds).

    p3: (B, H, W, C) stride-8 neck features (padded letterbox layout), any
    float dtype; pad_xy: (B, 2) int (px, py) pads in stride-8 cells.
    -> (saliency (B, H, W) f32, thresholds (B, T) f32, NaN-padded). The
    thresholder gets ``num_thresholds + 1`` classes (host
    ``select_thresholding``)."""
    B, H, W, _ = p3.shape
    mask = _grid_mask(pad_xy.to(p3.device), H, W)
    sal = _summarize(p3.float(), mask, summarizer)
    flat, fmask = sal.reshape(B, -1), mask.reshape(B, -1)
    if method == "recursive_otsu":
        thr = _recursive_otsu(flat, fmask, num_thresholds + 1)
    elif method == "quantile":
        thr = _quantile_thresholds(flat, fmask, num_thresholds + 1)
    else:
        raise ValueError(f"no device thresholder: {method}")
    return sal, thr


def eul_frontend_masks(p3: torch.Tensor, pad_xy: torch.Tensor, *, summarizer: str,
                       method: str, num_thresholds: int):
    """``eul_frontend`` with the threshold compare done on the device ->
    (masks (B, T, H, W) bool, saliency > thr; thr (B, T) f32 ascending,
    +inf for degenerate or missing node thresholds)."""
    sal, thr = eul_frontend(p3, pad_xy, summarizer=summarizer, method=method,
                            num_thresholds=num_thresholds)
    thr = torch.sort(torch.where(torch.isfinite(thr), thr, torch.full_like(thr, float("inf"))),
                     dim=1).values
    return sal[:, None] > thr[:, :, None, None], thr
