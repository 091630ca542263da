"""Centroid-distance OoD scoring, and kernel K3's wrapper.

Port of ood_in_object_detection_tpu/ood/distance.py (sklearn metric
semantics of the reference, ood_utils.py:2404-2430): rows are flattened and
L2-normalised, the distance of a box is the minimum over its (class, stride)
group's centroids, and groups are padded to ``Kmax`` with a mask.

:func:`min_group_distances` launches CUDA kernel K3
(``csrc/min_group_distance.cu``) for cosine and l2 on CUDA tensors and runs
:func:`min_group_distances_plain` on CPU tensors. L1 has no kernel, here as
in the JAX package; it stays plain PyTorch on every device
(:func:`min_distance_to_class_centroids`).
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

PAIRWISE_METRICS = ("l1", "l2", "cosine", "manhattan", "euclidean")
NO_CLUSTER_DISTANCE = 1000.0  # reference sentinel (ood_utils.py:2164)


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sklearn normalize(axis=1): rows with zero norm stay zero."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) with sklearn metric semantics."""
    if metric in ("l1", "manhattan"):
        return torch.abs(a[:, None, :] - b[None, :, :]).sum(-1)
    if metric in ("l2", "euclidean"):
        d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * a @ b.T
        return torch.sqrt(torch.clamp(d2, min=0.0))
    if metric == "cosine":
        return 1.0 - l2_normalize_rows(a) @ l2_normalize_rows(b).T
    raise ValueError(f"unknown metric {metric}")


class CentroidBank(NamedTuple):
    """centroids (nc, S, Kmax, D) f32; count (nc, S) — real centroids per group."""

    centroids: torch.Tensor
    count: torch.Tensor

    @property
    def num_classes(self):
        return self.centroids.shape[0]


def build_centroid_bank(clusters: Sequence[Sequence[np.ndarray]], feat_dim: int,
                        num_strides: int = 3, device="cpu") -> CentroidBank:
    """Pack the ragged [class][stride] -> (K, D) cluster lists into a padded bank."""
    nc = len(clusters)
    kmax = max([1] + [c.shape[0] for per in clusters for c in per
                      if isinstance(c, np.ndarray) and c.ndim == 2])
    cents = np.zeros((nc, num_strides, kmax, feat_dim), np.float32)
    count = np.zeros((nc, num_strides), np.int64)
    for i, per_cls in enumerate(clusters):
        for s, c in enumerate(per_cls):
            if isinstance(c, np.ndarray) and c.ndim == 2 and c.shape[0] > 0:
                cents[i, s, : c.shape[0]] = c
                count[i, s] = c.shape[0]
    return CentroidBank(torch.as_tensor(cents, device=device),
                        torch.as_tensor(count, device=device))


def min_group_distances_plain(feats: torch.Tensor, centroids: torch.Tensor,
                              kmask: torch.Tensor, metric: str) -> torch.Tensor:
    """Plain PyTorch: pairwise_distance to every centroid, masked min over K.
    (N, D), (G, K, D), (G, K) bool -> (N, G), inf for an empty group."""
    g, k, d = centroids.shape
    dmat = pairwise_distance(feats, centroids.reshape(g * k, d), metric)
    dmat = dmat.reshape(feats.shape[0], g, k)
    dmat = torch.where(kmask[None], dmat, torch.full_like(dmat, float("inf")))
    return dmat.amin(dim=-1)


class K3Plan(NamedTuple):
    """Kernel K3's schedule for one call (csrc/min_group_distance.cu): the
    ``wide`` tile or the narrow one, its rows and columns a block (bm, bn),
    groups a block (gr), the grid (runs of groups x row tiles), the D values
    a stage holds (chunk) and the thread groups that split them (ksplit)."""

    wide: bool
    bm: int
    bn: int
    gr: int
    runs: int
    row_tiles: int
    chunk: int
    ksplit: int


# (rows, centroid columns, chunk, ksplit) of a block: Narrow for K <= 64
# (100 blocks at N 2400, one wave), Wide for larger K (one group a block)
K3_NARROW = (24, 64, 64, 8)
K3_WIDE = (128, 128, 32, 1)


@functools.lru_cache(maxsize=256)
def k3_plan(n: int, g: int, k: int) -> K3Plan:
    """K <= 64: the narrow tile, a block taking as many whole groups as fit
    in 64 columns (all 60 of the eval path's at K 1); larger K: the wide
    tile, one group a block, its centroids in slices of 128."""
    wide = k > K3_NARROW[1]
    bm, bn, chunk, ksplit = K3_WIDE if wide else K3_NARROW
    gr = 1 if wide else max(1, min(g, bn // k))
    return K3Plan(wide, bm, bn, gr, -(-g // gr), -(-n // bm), chunk, ksplit)


def min_group_distances(feats: torch.Tensor, centroids: torch.Tensor,
                        kmask: torch.Tensor, metric: str) -> torch.Tensor:
    """``out[n, g] = min_k dist(feats[n], centroids[g, k])`` over masked-in
    k; inf where a group is empty. For cosine the rows of both sides must
    already be unit length (the kernel computes 1 - x.c).

    Replaces ops/pallas/distance.py:min_group_distances_pallas. CUDA tensors
    launch kernel K3 (cosine, l2) once, for any K and D; CPU tensors take
    :func:`min_group_distances_plain`. The checks are ordered so that the
    common case costs the host a few microseconds."""
    if feats.dim() != 2 or centroids.dim() != 3 or kmask.shape != centroids.shape[:2] \
            or centroids.shape[2] != feats.shape[1]:
        raise ValueError(f"min_group_distances: feats {tuple(feats.shape)}, centroids "
                         f"{tuple(centroids.shape)}, kmask {tuple(kmask.shape)} disagree")
    dev = feats.device
    if dev.type == "cpu":
        return min_group_distances_plain(feats, centroids, kmask, metric)
    from ..ops.kernels import _build

    if metric not in ("cosine", "l2", "euclidean"):
        raise ValueError(f"min_group_distances: kernel K3 has no {metric} metric")
    if not (dev.type == "cuda" and centroids.device == dev and kmask.device == dev
            and feats.is_contiguous() and centroids.is_contiguous()
            and kmask.is_contiguous()):
        _build.require_cuda("min_group_distances", feats=feats, centroids=centroids,
                            kmask=kmask)
    if feats.dtype != torch.float32 or centroids.dtype != torch.float32 \
            or kmask.dtype != torch.bool:
        raise TypeError("min_group_distances: needs f32 feats/centroids and a bool kmask")
    n, d = feats.shape
    g, k, _ = centroids.shape
    plan = k3_plan(n, g, k)
    out = feats.new_empty((n, g))
    code = _build.launcher("min_group_distance")(
        feats.data_ptr(), centroids.data_ptr(), kmask.data_ptr(), n, g, k, d,
        int(metric != "cosine"), int(plan.wide), plan.gr, out.data_ptr(),
        _build.stream_handle(dev))
    _build.count_launch(min_group_distances, device=dev.index)
    _build.check_launch("min_group_distance", code)
    return out


min_group_distances.launches = 0
min_group_distances.launches_by_device = collections.Counter()


def distances_to_all_class_centroids_stride0(feats: torch.Tensor, bank: CentroidBank,
                                             metric: str) -> torch.Tensor:
    """(N, D) -> (N, nc) min distance of each row to every class's stride-0
    centroids, inf where a class has none: the EUL proposals' rank
    (reference ood_utils.py:1917-1998). Cosine and l2 are kernel K3's
    contract with one group per class; cosine normalises both sides first,
    as sklearn does. L1 has no kernel and stays plain on every device."""
    cents = bank.centroids[:, 0]                                   # (nc, Kmax, D)
    kmask = torch.arange(cents.shape[1], device=cents.device)[None, :] < bank.count[:, 0, None]
    if metric in ("cosine", "l2", "euclidean"):
        if metric == "cosine":
            feats, cents = l2_normalize_rows(feats), l2_normalize_rows(cents)
        return min_group_distances(feats.float().contiguous(), cents.contiguous(),
                                   kmask.contiguous(), metric)
    nc, kmax, d = cents.shape
    dmat = pairwise_distance(feats, cents.reshape(nc * kmax, d), metric).reshape(-1, nc, kmax)
    return torch.where(kmask[None], dmat, torch.full_like(dmat, float("inf"))).amin(dim=-1)


def min_distance_to_class_centroids(feats: torch.Tensor, cls: torch.Tensor,
                                    stride_idx: torch.Tensor, bank: CentroidBank,
                                    metric: str) -> torch.Tensor:
    """min_k dist(feat_i, centroids[cls_i, stride_i, k]) -> (N,); a box whose
    group has no cluster gets NO_CLUSTER_DISTANCE (ood_utils.py:2158-2164)."""
    cents = bank.centroids[cls.long(), stride_idx.long()]      # (N, Kmax, D)
    cnt = bank.count[cls.long(), stride_idx.long()]            # (N,)
    if metric in ("l1", "manhattan"):
        d = torch.abs(feats[:, None, :] - cents).sum(-1)
    elif metric in ("l2", "euclidean"):
        d2 = (feats * feats).sum(-1)[:, None] + (cents * cents).sum(-1) \
            - 2.0 * torch.einsum("nd,nkd->nk", feats, cents)
        d = torch.sqrt(torch.clamp(d2, min=0.0))
    elif metric == "cosine":
        d = 1.0 - torch.einsum("nd,nkd->nk", l2_normalize_rows(feats), l2_normalize_rows(cents))
    else:
        raise ValueError(f"unknown metric {metric}")
    kmask = torch.arange(cents.shape[1], device=feats.device)[None, :] < cnt[:, None]
    dmin = torch.where(kmask, d, torch.full_like(d, float("inf"))).amin(dim=-1)
    return torch.where(cnt > 0, dmin, torch.full_like(dmin, NO_CLUSTER_DISTANCE))
