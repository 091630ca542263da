"""Enhanced Unknown Localization (EUL): saliency maps over stride-8 features,
multi-level thresholding, connected-component box proposals, heuristics +
distance ranking + NMS.

The NumPy/scipy parts are copies of ood_in_object_detection_tpu/ood/unknown.py
(that package's ood/__init__.py imports jax), held equal to the originals by
tests/test_torch_unknown.py: the summarizers, the thresholders, the
connected-component boxes, the proposal heuristics, ranking and selection.
``k_means_thresholding`` runs the port's k-means (``ood/kmeans.py``, the
same labels and centres as scikit-learn's) where the JAX package runs
scikit-learn's.

The batched front end (``eul_frontend_dispatch`` / ``_batched`` /
``_finish``) runs ``unknown_device.eul_frontend_masks`` on the map's device
(the card unless the map lies on the CPU) and hands each image's cropped
bool masks and thresholds to ``unknown_candidates_for_image``. A summarizer
or thresholder without a device path (``multithreshold_otsu``,
``fast_otsu``, ``k_means``) takes the host functions of this module, as in
the JAX package.

Reference: unknown_localization_utils.py and its caller in
ood_utils.py:641-1174 (reference layout CHW; ours HWC).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage
from scipy.stats import entropy, gmean, median_abs_deviation

from ..core.config import CUSTOM_HYP, UnkEnhancementParams

STRIDES_RATIO = (8, 16, 32)

# ---------------------------------------------------------------------------
# Saliency summarization (HWC -> HW)
# ---------------------------------------------------------------------------


def ftmap_minus_mean_then_abs_sum(f: np.ndarray) -> np.ndarray:
    mean = f.mean(axis=(0, 1))
    return np.abs(f - mean).sum(axis=-1)


def ftmap_minus_mean_then_sum(f: np.ndarray) -> np.ndarray:
    mean = f.mean(axis=(0, 1))
    return (f - mean).sum(axis=-1)


def sum_of_ftmaps(f: np.ndarray) -> np.ndarray:
    return f.sum(axis=-1)


def std_of_ftmaps(f: np.ndarray) -> np.ndarray:
    return f.std(axis=-1)


def iqr_of_ftmaps(f: np.ndarray) -> np.ndarray:
    return np.percentile(f, 75, axis=-1) - np.percentile(f, 25, axis=-1)


def mean_absolute_deviation_of_ftmaps(f: np.ndarray) -> np.ndarray:
    mean = f.mean(axis=(0, 1))
    return np.abs(f - mean).mean(axis=-1)


def median_absolute_deviation_of_ftmaps(f: np.ndarray) -> np.ndarray:
    mean = f.mean(axis=(0, 1))
    return median_abs_deviation(f - mean, axis=-1)


SUMMARIZERS = {
    "ftmap_minus_mean_of_ftmaps_then_abs_sum": ftmap_minus_mean_then_abs_sum,
    "ftmap_minus_mean_of_ftmaps_then_sum": ftmap_minus_mean_then_sum,
    "sum_of_ftmaps": sum_of_ftmaps,
    "std_of_ftmaps": std_of_ftmaps,
    "iqr_of_ftmaps": iqr_of_ftmaps,
    "mean_absolute_deviation_of_ftmaps": mean_absolute_deviation_of_ftmaps,
    "median_absolute_deviation_of_ftmaps": median_absolute_deviation_of_ftmaps,
}


def select_summarizer(name: str) -> Callable:
    if name not in SUMMARIZERS:
        raise ValueError(f"invalid summarization method: {name}")
    return SUMMARIZERS[name]


# ---------------------------------------------------------------------------
# Threshold computation
# ---------------------------------------------------------------------------


def threshold_otsu(values: np.ndarray, nbins: int = 256) -> float:
    """Classic Otsu on an nbins histogram (skimage.filters.threshold_otsu
    definition: maximize inter-class variance; returns bin center)."""
    values = np.asarray(values, np.float64).ravel()
    counts, edges = np.histogram(values, nbins)
    centers = (edges[:-1] + edges[1:]) / 2
    counts = counts.astype(np.float64)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((counts * centers)[::-1]) / np.maximum(w2[::-1], 1e-12))[::-1]
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[:-1][np.argmax(var12)])


def recursive_otsu(image: np.ndarray, num_classes: int) -> List[float]:
    """reference unknown_localization_utils.py:175-200: split at Otsu, recurse
    on each side until depth, return sorted unique thresholds."""
    thresholds: List[float] = []

    def rec(vals: np.ndarray, depth: int):
        if depth >= num_classes - 1 or vals.size == 0 or np.ptp(vals) == 0:
            return
        t = threshold_otsu(vals)
        thresholds.append(t)
        rec(vals[vals <= t], depth + 1)
        rec(vals[vals > t], depth + 1)

    rec(np.asarray(image).ravel(), 1)
    return sorted(set(thresholds))


def multi_threshold_otsu(image: np.ndarray, num_classes: int, nbins: int = 128) -> List[float]:
    """Exact multi-Otsu over histogram bins (skimage threshold_multiotsu
    semantics, nbins=128 as the reference passes).

    Dynamic program over cumulative moments — O(k * nbins^2) — instead of
    the C(nbins-1, k) exhaustive cut search (which at num_classes=5 is
    ~10M Python iterations, minutes per image): f[j][h] = best sum of
    between-class terms w*m^2 splitting bins [0, h) into j classes; the
    argmax table reconstructs the optimal cuts. Same objective, same
    optimum (asserted against the exhaustive search in tests)."""
    vals = np.asarray(image, np.float64).ravel()
    counts, edges = np.histogram(vals, nbins)
    centers = (edges[:-1] + edges[1:]) / 2
    p = counts.astype(np.float64)
    csum = np.concatenate([[0.0], np.cumsum(p)])
    cmean = np.concatenate([[0.0], np.cumsum(p * centers)])

    # V[lo, hi] = w * m^2 of bins [lo, hi): vectorized (nbins+1, nbins+1)
    w = csum[None, :] - csum[:, None]
    m = cmean[None, :] - cmean[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        V = np.where(w > 0, m * m / np.where(w > 0, w, 1.0), 0.0)

    n_classes = num_classes
    # f[h] = best objective splitting bins [0, h) into j classes (each class
    # gets >= 1 bin); A[j][h] = the argmax start bin of the last class
    f = V[0].copy()                      # j = 1
    A = np.zeros((n_classes + 1, nbins + 1), np.int64)
    for j in range(2, n_classes + 1):
        g = np.full(nbins + 1, -np.inf)
        for h in range(j, nbins + 1):
            ms = np.arange(j - 1, h)
            cand = f[ms] + V[ms, h]
            i = int(np.argmax(cand))     # ties: smallest cut (lexicographic)
            g[h] = cand[i]
            A[j, h] = ms[i]
        f = g
    cuts = []
    h = nbins
    for j in range(n_classes, 1, -1):
        h = int(A[j, h])
        cuts.append(h)
    cuts.reverse()
    return sorted(set(float(centers[c - 1]) for c in cuts))


def k_means_thresholding(image: np.ndarray, num_clusters: int) -> List[float]:
    """Midpoints of the sorted centres of a k-means (seed 0) over the flat
    map (ood_in_object_detection_tpu/ood/unknown.py:175-181, on the port's
    ood/kmeans.py in place of scikit-learn's)."""
    from .kmeans import KMeans

    flat = np.asarray(image).ravel().reshape(-1, 1)
    km = KMeans(n_clusters=num_clusters, random_state=0).fit(flat)
    centers = sorted(km.cluster_centers_.ravel().tolist())
    return sorted(set((centers[i] + centers[i + 1]) / 2 for i in range(len(centers) - 1)))


def quantile_thresholding(image: np.ndarray, num_quantiles: int) -> List[float]:
    qs = np.linspace(0, 1, num_quantiles + 1)[1:-1]
    return sorted(set(np.quantile(np.asarray(image).ravel(), qs).tolist()))


def fast_otsu_pyramid(image: np.ndarray, num_classes: int) -> List[float]:
    """Histogram-pyramid fast multi-Otsu. The reference's OtsuFastMultithreshold
    (unknown_localization_utils.py:375-419) ships with a placeholder threshold
    hunter, reducing to scaled first-guess (mid-histogram) thresholds; here we
    refine each pyramid guess with one exact Otsu pass over its neighbourhood,
    which is strictly closer to true multi-Otsu at the same cost class."""
    k = num_classes - 1
    vals = np.asarray(image, np.float64).ravel()
    guesses = np.quantile(vals, np.linspace(0, 1, k + 2)[1:-1])
    out = []
    for g in guesses:
        lo, hi = g - vals.std(), g + vals.std()
        sel = vals[(vals >= lo) & (vals <= hi)]
        out.append(threshold_otsu(sel) if sel.size > 16 and np.ptp(sel) > 0 else float(g))
    return sorted(set(out))


def _recursive_otsu_tricked(im: np.ndarray, n: int) -> List[float]:
    """recursive_otsu + the reference's OTSU_RECURSIVE_TRICK_FOR_4_THRS:
    with 4 requested thresholds (5 classes) keep only the middle slice
    [2:-1] of the sorted unique thresholds
    (reference unknown_localization_utils.py:186-189)."""
    thrs = recursive_otsu(im, n)
    if CUSTOM_HYP.unk.OTSU_RECURSIVE_TRICK_FOR_4_THRS and n == 5:
        thrs = thrs[2:-1]
    return thrs


def select_thresholding(name: str, num_thresholds: int) -> Callable[[np.ndarray], List[float]]:
    n = num_thresholds + 1  # reference NUM_THRS = NUM_THRESHOLDS + 1 classes
    table = {
        "recursive_otsu": lambda im: _recursive_otsu_tricked(im, n),
        "multithreshold_otsu": lambda im: multi_threshold_otsu(im, n),
        "k_means": lambda im: k_means_thresholding(im, n),
        "quantile": lambda im: quantile_thresholding(im, n),
        "fast_otsu": lambda im: fast_otsu_pyramid(im, n),
    }
    if name not in table:
        raise ValueError(f"invalid thresholding method: {name}")
    return table[name]


# ---------------------------------------------------------------------------
# Connected components -> boxes
# ---------------------------------------------------------------------------

_EIGHT_CONN = np.ones((3, 3), int)


def extract_boxes_from_saliency(saliency: np.ndarray, thresholds: Sequence[float]) -> List[np.ndarray]:
    """Per threshold: binarize, 8-connected label, one xyxy box per region
    ([x_min, y_min, x_max, y_max] with exclusive max, matching regionprops
    bbox; reference unknown_localization_utils.py:16-39).

    Boxes come from a sort+segment-reduce over the labelled pixels instead of
    ``ndimage.find_objects`` + a per-region Python loop (~2.2x faster at the
    typical 80x80/500-region load). ``np.nonzero`` emits raster order and the
    stable argsort preserves it within each label, so each group's rows are
    y-ascending: y1/y2 are the group's first/last row, x1/x2 segment min/max.
    Region order stays ndimage label order (== find_objects order)."""
    return extract_boxes_from_masks([saliency > t for t in thresholds])


def extract_boxes_from_masks(masks) -> List[np.ndarray]:
    """One xyxy box per 8-connected region of each binary mask (see
    ``extract_boxes_from_saliency``; masks may come pre-thresholded from the
    device front-end)."""
    out = []
    for mask in masks:
        lab, n = ndimage.label(mask, structure=_EIGHT_CONN)
        if n == 0:
            out.append(np.empty((0, 4), np.float32))
            continue
        ys, xs = np.nonzero(lab)
        l = lab[ys, xs]
        order = np.argsort(l, kind="stable")
        l_s, ys_s, xs_s = l[order], ys[order], xs[order]
        starts = np.searchsorted(l_s, np.arange(1, n + 1))
        ends = np.append(starts[1:], len(l_s))
        x1 = np.minimum.reduceat(xs_s, starts)
        x2 = np.maximum.reduceat(xs_s, starts)
        y1 = ys_s[starts]
        y2 = ys_s[ends - 1]
        out.append(np.stack([x1, y1, x2 + 1, y2 + 1], 1).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# Proposal postprocessing
# ---------------------------------------------------------------------------


def _iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    from ..ood.matching import iou_matrix_np

    return iou_matrix_np(a, b)


def greedy_nms_np(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """torchvision.ops.nms semantics: keep indices in descending score order."""
    order = np.argsort(-scores)
    keep = []
    sup = np.zeros(len(boxes), bool)
    for i in order:
        if sup[i]:
            continue
        keep.append(i)
        ious = _iou_np(boxes[i : i + 1], boxes)[0]
        sup |= (ious > iou_thr) & (np.arange(len(boxes)) != i)
    return np.asarray(keep, int)


def rank_distances(dist_matrix: np.ndarray, op: str) -> np.ndarray:
    """Reduce (n_classes_with_clusters, n_props) distance matrix to a rank
    score per proposal (reference ood_utils.py:1056-1092)."""
    if op == "mean":
        return dist_matrix.mean(axis=0)
    if op == "max":
        return dist_matrix.max(axis=0)
    if op == "sum":
        return dist_matrix.sum(axis=0)
    if op == "min":
        return dist_matrix.min(axis=0) * 100  # reference compensation (:1078)
    if op == "geometric_mean":
        return gmean(dist_matrix, axis=0)
    if op == "entropy":
        p = dist_matrix / dist_matrix.sum(axis=0, keepdims=True)
        return entropy(p, axis=0)
    raise NotImplementedError(op)


def collect_unk_candidates(
    boxes_per_thr: List[np.ndarray],
    padding_xy: Tuple[int, int],
    unpadded_hw: Tuple[int, int],
    pred_boxes_ftmap: np.ndarray,
    hyp: Optional[UnkEnhancementParams] = None,
) -> np.ndarray:
    """First half of ``postprocess_unk_proposals``: per-threshold heuristics
    + concatenation -> candidate proposals (n, 4) in padded-ftmap coords
    (reference postprocess_unk_bboxes ood_utils.py:934-1034). Split out so a
    batch-level caller can collect every image's candidates FIRST, rank the
    whole batch in one device call, and finish with
    ``select_unk_proposals`` — one round trip per batch instead of one per
    image."""
    hyp = hyp or CUSTOM_HYP.unk
    h, w = unpadded_hw
    kept = []
    for idx_thr, props in enumerate(boxes_per_thr):
        if len(props) == 0:
            continue
        props = props.copy()
        props[:, [0, 2]] += padding_xy[0]
        props[:, [1, 3]] += padding_xy[1]
        if not hyp.USE_HEURISTICS:
            kept.append(props)
            continue
        if hyp.USE_SIMPLE_HEURISTICS:
            if idx_thr == 0 and not hyp.USE_FIRST_THRESHOLD:
                continue
            bw = props[:, 2] - props[:, 0]
            bh = props[:, 3] - props[:, 1]
            mask = (bw >= hyp.MIN_BOX_SIZE) & (bh >= hyp.MIN_BOX_SIZE)
            mask &= (bw < int(hyp.MAX_BOX_SIZE_PERCENT * w)) & (bh < int(hyp.MAX_BOX_SIZE_PERCENT * h))
            props = props[mask]
            if len(pred_boxes_ftmap) > 0 and len(props) > 0 and hyp.MAX_IOU_WITH_PREDS > 0:
                ious = _iou_np(props, pred_boxes_ftmap)
                props = props[ious.max(axis=1) < hyp.MAX_IOU_WITH_PREDS]
            if len(pred_boxes_ftmap) > 0 and len(props) > 0 and hyp.MAX_INTERSECTION_W_PREDS:
                lt = np.maximum(props[:, None, :2], pred_boxes_ftmap[None, :, :2])
                rb = np.minimum(props[:, None, 2:], pred_boxes_ftmap[None, :, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[..., 0] * wh[..., 1]
                pred_area = np.clip(pred_boxes_ftmap[:, 2] - pred_boxes_ftmap[:, 0], 0, None) * \
                    np.clip(pred_boxes_ftmap[:, 3] - pred_boxes_ftmap[:, 1], 0, None)
                ratio = inter / np.maximum(pred_area[None, :], 1e-12)
                props = props[ratio.max(axis=1) <= hyp.MAX_INTERSECTION_W_PREDS]
        if len(props) == 0:
            continue
        kept.append(props)

    if not kept:
        return np.empty((0, 4), np.float32)
    return np.concatenate(kept, axis=0).astype(np.float32)


def select_unk_proposals(
    all_props: np.ndarray,
    rank_result,  # None | (n,) scores | ((n,) scores, (n,) closest ids)
    hyp: Optional[UnkEnhancementParams] = None,
    unk_prop_thr: Optional[float] = None,
    class_thresholds: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Second half of ``postprocess_unk_proposals``: rank-ordering/NMS,
    threshold gates, top-K (reference ood_utils.py:1036-1174) over already-
    collected candidates with already-computed rank scores."""
    hyp = hyp or CUSTOM_HYP.unk
    if len(all_props) == 0:
        empty = np.empty((0, 4), np.float32)
        return (empty, np.empty(0, np.float32)) if (hyp.USE_HEURISTICS and hyp.RANK_BOXES) else (empty, None)

    if not (hyp.USE_HEURISTICS and hyp.RANK_BOXES):
        return all_props, None

    all_ranks = np.empty(0, np.float32)
    all_closest = None
    if rank_result is not None:
        if isinstance(rank_result, tuple):
            all_ranks, all_closest = (np.asarray(rank_result[0]),
                                      np.asarray(rank_result[1]))
        else:
            all_ranks = np.asarray(rank_result)
    if hyp.rank.MAX_NUM_UNK_BOXES_PER_IMAGE > 0 and len(all_ranks) > 0:
        if hyp.rank.NMS > 0:
            score = all_ranks if hyp.rank.GET_BOXES_WITH_GREATER_RANK else -all_ranks
            keep = greedy_nms_np(all_props, score, hyp.rank.NMS)
        else:
            keep = np.argsort(all_ranks)
            if hyp.rank.GET_BOXES_WITH_GREATER_RANK:
                keep = keep[::-1]
        all_props = all_props[keep]
        all_ranks = all_ranks[keep]
        if all_closest is not None:
            all_closest = all_closest[keep]
        if (hyp.rank.USE_OOD_THR_TO_REMOVE_PROPS and all_closest is not None
                and class_thresholds is not None):
            # per-closest-class gate (reference ood_utils.py:1141-1152
            # 'min' path: keep proposals with distance < the closest known
            # class's own threshold; we index thresholds by the actual class
            # id where the reference indexes by filtered-row position)
            thr = np.asarray(class_thresholds, np.float64)[all_closest]
            keep_thr = all_ranks < thr
            all_props = all_props[keep_thr]
            all_ranks = all_ranks[keep_thr]
        elif hyp.rank.USE_UNK_PROPOSALS_THR and unk_prop_thr is not None:
            # gate proposals by the InD rank-score threshold (reference
            # ood_utils.py:1146-1160 `distances < thresholds[80][0]`)
            keep_thr = all_ranks < unk_prop_thr
            all_props, all_ranks = all_props[keep_thr], all_ranks[keep_thr]
        k = hyp.rank.MAX_NUM_UNK_BOXES_PER_IMAGE
        all_props, all_ranks = all_props[:k], all_ranks[:k]
    return all_props, all_ranks


def postprocess_unk_proposals(
    boxes_per_thr: List[np.ndarray],
    padding_xy: Tuple[int, int],
    unpadded_hw: Tuple[int, int],
    pred_boxes_ftmap: np.ndarray,
    rank_score_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    hyp: Optional[UnkEnhancementParams] = None,
    unk_prop_thr: Optional[float] = None,
    class_thresholds: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Heuristics + ranking + NMS + top-K over raw per-threshold proposals
    (reference postprocess_unk_bboxes ood_utils.py:934-1174) =
    ``collect_unk_candidates`` + one rank call + ``select_unk_proposals``.

    rank_score_fn: maps padded-ftmap-space proposals (n,4) to a rank score per
    proposal (lower = more unknown with default GET_BOXES_WITH_GREATER_RANK
    False); typically distance-to-centroid reductions — supplied by the
    distance method to keep this module method-agnostic. May return a tuple
    (scores, closest_class_ids) for the USE_OOD_THR_TO_REMOVE_PROPS 'min'
    path (ood_utils.py:1064-1070,1141-1152): proposals are then gated by the
    per-closest-class distance threshold (``class_thresholds``, stride 0).
    Rank scores are per-box (independent of the threshold group a box came
    from), so ONE call over the concatenated survivors is exactly equivalent
    to the reference's per-threshold-group calls (ood_utils.py:1036-1092)."""
    hyp = hyp or CUSTOM_HYP.unk
    all_props = collect_unk_candidates(boxes_per_thr, padding_xy, unpadded_hw,
                                       pred_boxes_ftmap, hyp)
    rank_result = None
    if (hyp.USE_HEURISTICS and hyp.RANK_BOXES and rank_score_fn is not None
            and len(all_props)):
        rank_result = rank_score_fn(all_props)
    return select_unk_proposals(all_props, rank_result, hyp,
                                unk_prop_thr=unk_prop_thr,
                                class_thresholds=class_thresholds)


def eul_frontend_dispatch(
    p3_batch,                # (B, H, W, C) padded stride-8 neck feature maps
    ratio_pads: Sequence,    # B x ((r, r), (dw, dh)) from letterbox
    hyp: Optional[UnkEnhancementParams] = None,
):
    """Enqueue the batched saliency + thresholds + binarization on the map's
    device -> (bool masks (B, T, H, W), thresholds (B, T) ascending with
    +inf padding, pads (B, 2) in stride-8 cells, (H, W)), all but the pads
    still on the device; None when the configured summarizer or
    thresholder has no device path (the caller then takes the host
    functions)."""
    hyp = hyp or CUSTOM_HYP.unk
    from .unknown_device import DEVICE_SUMMARIZERS, DEVICE_THRESHOLDERS, eul_frontend_masks

    if (hyp.SUMMARIZATION_METHOD not in DEVICE_SUMMARIZERS
            or hyp.THRESHOLDING_METHOD not in DEVICE_THRESHOLDERS):
        return None
    stride = STRIDES_RATIO[0]
    pads = np.array([[int(dw / stride), int(dh / stride)]
                     for (_, (dw, dh)) in ratio_pads], np.int64)
    p3 = torch.as_tensor(p3_batch)
    masks, thr = eul_frontend_masks(
        p3, torch.as_tensor(pads, device=p3.device),
        summarizer=hyp.SUMMARIZATION_METHOD, method=hyp.THRESHOLDING_METHOD,
        num_thresholds=hyp.NUM_THRESHOLDS)
    return masks, thr, pads, tuple(p3.shape[1:3])


def eul_frontend_batched(
    p3_batch,                # (B, H, W, C) padded stride-8 neck feature maps
    ratio_pads: Sequence,    # B x ((r, r), (dw, dh)) from letterbox
    hyp: Optional[UnkEnhancementParams] = None,
) -> Optional[List[Tuple[np.ndarray, List[float]]]]:
    """Per image (cropped bool masks (T, h, w), ascending unique thresholds)
    for ``unknown_candidates_for_image(precomputed=...)``, or None when the
    configured summarizer or thresholder has no device path."""
    return eul_frontend_finish(eul_frontend_dispatch(p3_batch, ratio_pads, hyp), hyp)


def eul_frontend_finish(
    dispatched, hyp: Optional[UnkEnhancementParams] = None,
) -> Optional[List[Tuple[np.ndarray, List[float]]]]:
    """Copy the masks and thresholds to the host (two copies a batch), then
    per image: the finite thresholds deduplicated by first index, the masks
    of those cropped to ``[py:H-py, px:W-px]``, and
    OTSU_RECURSIVE_TRICK_FOR_4_THRS."""
    if dispatched is None:
        return None
    hyp = hyp or CUSTOM_HYP.unk
    masks, thr, pads, (H, W) = dispatched
    masks, thr = masks.cpu().numpy(), thr.cpu().numpy()
    trick = (hyp.OTSU_RECURSIVE_TRICK_FOR_4_THRS
             and hyp.THRESHOLDING_METHOD == "recursive_otsu"
             and hyp.NUM_THRESHOLDS + 1 == 5)
    out = []
    for i in range(len(masks)):
        px, py = int(pads[i, 0]), int(pads[i, 1])
        finite = thr[i][np.isfinite(thr[i])]  # ascending prefix
        vals, first_idx = np.unique(finite, return_index=True)
        sel = masks[i][first_idx][:, py : H - py, px : W - px]
        ts = [float(v) for v in vals]
        if trick:  # reference unknown_localization_utils.py:186-189
            ts, sel = ts[2:-1], sel[2:-1]
        out.append((sel, ts))
    return out


def unknown_proposals_for_image(
    p3_feat: Optional[np.ndarray],  # (H, W, C) padded stride-8 neck map, or
                                    # None when `precomputed` + `padded_hw`
                                    # are given (the feature map never left
                                    # the device; the D2H fetch of a full
                                    # neck map is the EUL loop's dominant
                                    # wire cost — PERF.md r5 EUL post-mortem)
    ratio_pad,                    # ((r, r), (dw, dh)) from letterbox
    pred_boxes_xyxy: np.ndarray,  # (n, 4) predictions in image pixels
    rank_score_fn: Optional[Callable] = None,
    hyp: Optional[UnkEnhancementParams] = None,
    unk_prop_thr: Optional[float] = None,
    class_thresholds: Optional[np.ndarray] = None,
    precomputed: Optional[Tuple[np.ndarray, List[float]]] = None,
    padded_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Full EUL pass for one image -> (proposals xyxy in image pixels,
    decisions (all 0 = unknown), rank scores or None).

    Mirrors compute_extra_possible_unkwnown_bboxes_and_decision
    (ood_utils.py:641-898): stride-8, unpad by ratio_pad/8, saliency,
    thresholds, CC boxes, postprocess, scale x8 back to image space.

    ``precomputed``: (cropped saliency, thresholds) from the batched device
    front-end (``eul_frontend_batched``) — skips the host summarizer and
    thresholding, the two stages profiling shows dominate the host cost.
    With ``precomputed`` the map DATA is only needed by the rank fn, so a
    device-backed ``rank_score_fn`` lets callers pass ``p3_feat=None`` plus
    ``padded_hw=(H, W)``.
    """
    hyp = hyp or CUSTOM_HYP.unk
    all_props = unknown_candidates_for_image(
        p3_feat, ratio_pad, pred_boxes_xyxy, hyp=hyp,
        precomputed=precomputed, padded_hw=padded_hw)
    rank_result = None
    if (hyp.USE_HEURISTICS and hyp.RANK_BOXES and rank_score_fn is not None
            and len(all_props)):
        rank_result = rank_score_fn(all_props)
    return finish_unknown_proposals(all_props, rank_result, hyp=hyp,
                                    unk_prop_thr=unk_prop_thr,
                                    class_thresholds=class_thresholds)


def unknown_candidates_for_image(
    p3_feat: Optional[np.ndarray],
    ratio_pad,
    pred_boxes_xyxy: np.ndarray,
    hyp: Optional[UnkEnhancementParams] = None,
    precomputed: Optional[Tuple[np.ndarray, List[float]]] = None,
    padded_hw: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Candidate half of ``unknown_proposals_for_image``: saliency (or the
    device front-end's precomputed masks) -> CC boxes -> heuristics ->
    candidates (n, 4) in PADDED-FTMAP coords. A batch-level caller collects
    these for every image, ranks the whole batch in one device call, then
    calls ``finish_unknown_proposals`` per image."""
    hyp = hyp or CUSTOM_HYP.unk
    stride = STRIDES_RATIO[0]
    (_, _), (dw, dh) = ratio_pad
    px = int(dw / stride)
    py = int(dh / stride)
    if p3_feat is None:
        assert precomputed is not None and padded_hw is not None, \
            "p3_feat=None requires precomputed masks and padded_hw"
        H, W = padded_hw
        unpadded_shape = (H - 2 * py, W - 2 * px)
    else:
        H, W = p3_feat.shape[:2]
        unpadded = p3_feat[py : H - py, px : W - px]
        unpadded_shape = unpadded.shape[:2]

    if precomputed is not None:
        sal_or_masks, thresholds = precomputed
        if sal_or_masks.ndim == 3:  # (T, h, w) bool masks from the device
            boxes_per_thr = extract_boxes_from_masks(sal_or_masks)
        else:                       # (h, w) saliency
            boxes_per_thr = extract_boxes_from_saliency(sal_or_masks, thresholds)
    else:
        saliency = select_summarizer(hyp.SUMMARIZATION_METHOD)(unpadded)
        thr_fn = select_thresholding(hyp.THRESHOLDING_METHOD, hyp.NUM_THRESHOLDS)
        thresholds = thr_fn(saliency)
        boxes_per_thr = extract_boxes_from_saliency(saliency, thresholds)

    return collect_unk_candidates(boxes_per_thr, (px, py), unpadded_shape,
                                  pred_boxes_xyxy / stride, hyp)


def finish_unknown_proposals(
    all_props: np.ndarray,
    rank_result,
    hyp: Optional[UnkEnhancementParams] = None,
    unk_prop_thr: Optional[float] = None,
    class_thresholds: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Selection half of ``unknown_proposals_for_image``: rank-order/NMS/
    gates/top-K over candidates (+ their rank scores), then scale back to
    image pixels (reference ood_utils.py:1036-1174, 898-932)."""
    hyp = hyp or CUSTOM_HYP.unk
    stride = STRIDES_RATIO[0]
    props, ranks = select_unk_proposals(all_props, rank_result, hyp,
                                        unk_prop_thr=unk_prop_thr,
                                        class_thresholds=class_thresholds)
    props_img = props * stride
    decisions = np.zeros(len(props_img), int)  # all proposals are unknown (ref :926-932)
    return props_img, decisions, ranks
