"""OoD methods: fit on the host, decide on the device, fixed shapes.

Port of ood_in_object_detection_tpu/ood/methods.py (reference OODMethod
hierarchy, ood_utils.py:44-3521):

    extract: model outputs + matches      -> per-(class[,stride]) activations
    fit:     activations (+ tpr)          -> clusters / thresholds / min-max
    decide:  batch outputs + fitted state -> (B, max_det) 1=InD / 0=OoD

Decision conventions are the reference's: logits methods call a box OoD when
score < thr[cls], with 0 for an unfit class (ood_utils.py:1195-1208, 612);
distance methods call it InD when dist < thr[cls, stride] and OoD when there
is no cluster or no threshold (ood_utils.py:2147-2180). Clusters are one
centroid per group (``one``) or the centroids of a host-side cluster search
(``ood/clustering.py``).
The SDR methods (Umap, CosineIvis, L1Ivis, L2Ivis) carry a fitted
per-stride embedding in ``sdr_state``, applied by ``transform_fn``
(``ood/sdr.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import CUSTOM_HYP
from .clustering import fit_cluster_labels
from .distance import (
    CentroidBank,
    NO_CLUSTER_DISTANCE,
    build_centroid_bank,
    l2_normalize_rows,
    min_distance_to_class_centroids,
    min_group_distances,
    pairwise_distance,
)
from .scores import LOGITS_METHODS, logits_score_fn, table_lookup
from .sdr import fit_stride_embedders
from .thresholds import (
    generate_thresholds_per_class,
    generate_thresholds_per_class_per_stride,
    pack_thresholds_per_class,
    pack_thresholds_per_class_per_stride,
)

DISTANCE_METHODS = ("L1_cl_stride", "L2_cl_stride", "Cosine_cl_stride",
                    "Umap", "CosineIvis", "L1Ivis", "L2Ivis")
OOD_METHOD_CHOICES = LOGITS_METHODS + DISTANCE_METHODS
# the methods with a fitted embedding (supervised dimensionality reduction)
SDR_METHODS = ("Umap", "CosineIvis", "L1Ivis", "L2Ivis")

_METRIC_OF = {"L1_cl_stride": "l1", "L2_cl_stride": "l2", "Cosine_cl_stride": "cosine",
              "Umap": "cosine", "CosineIvis": "cosine", "L1Ivis": "l1", "L2Ivis": "l2"}


def _cpu(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclasses.dataclass
class LogitsOODMethod:
    """MSP / Energy / ODIN / Sigmoid / NoMethod with per-class thresholds."""

    name: str
    # None -> the reference CLI defaults: ODIN T=1000, everything else T=1
    temper: Optional[float] = None
    is_distance_method: bool = False
    # False scores post-sigmoid probabilities (reference
    # ood_evaluation.py:67 use_values_before_sigmoid, default True)
    use_values_before_sigmoid: bool = True
    thresholds: Optional[List[Optional[float]]] = None
    min_score: Optional[np.ndarray] = None
    max_score: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.name not in LOGITS_METHODS:
            raise ValueError(f"unknown logits method {self.name}")
        if self.temper is None:
            self.temper = 1000.0 if self.name == "ODIN" else 1.0

    def _score(self, logits: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        raw = logits_score_fn(self.name, self.temper)
        # Sigmoid's score is already sigmoid(logit)[cls]: never apply it twice
        if self.name == "Sigmoid" or self.use_values_before_sigmoid:
            return raw(logits, cls)
        return raw(torch.sigmoid(logits), cls)

    def scores_from_logits(self, logits: np.ndarray, cls: np.ndarray) -> np.ndarray:
        if len(logits) == 0:
            return np.empty(0, np.float32)
        return self._score(_cpu(logits), torch.as_tensor(np.asarray(cls))).numpy()

    def compute_scores_from_activations(self, acts_per_class: Sequence[np.ndarray]
                                        ) -> List[np.ndarray]:
        """acts_per_class[c] = (N_c, nc) logits of the valid preds of class c;
        also records the per-class min/max for INDness."""
        scores = []
        for c, acts in enumerate(acts_per_class):
            acts = np.asarray(acts)
            scores.append(np.empty(0, np.float32) if acts.size == 0
                          else self.scores_from_logits(acts, np.full(len(acts), c)))
        self.min_score = np.array([s.min() if s.size else 0.0 for s in scores], np.float32)
        self.max_score = np.array([s.max() if s.size else 0.0 for s in scores], np.float32)
        return scores

    def generate_thresholds(self, ind_scores: Sequence[np.ndarray], tpr: float):
        self.thresholds = generate_thresholds_per_class(ind_scores, tpr, is_distance=False)
        return self.thresholds

    def packed_thresholds(self, device="cpu") -> torch.Tensor:
        # the reference stores 0 for unfit classes (ood_utils.py:612)
        t = np.nan_to_num(pack_thresholds_per_class(self.thresholds), nan=0.0)
        return torch.as_tensor(t, device=device)

    def decide(self, logits, cls, valid) -> torch.Tensor:
        """(B,N,nc),(B,N),(B,N) -> (B,N) 1=InD / 0=OoD (invalid boxes: 0)."""
        thr = table_lookup(self.packed_thresholds(logits.device), cls)
        s = self._score(logits, cls)
        return torch.where(valid, (s >= thr).int(), torch.zeros_like(thr, dtype=torch.int32))

    def raw_scores(self, logits, cls) -> torch.Tensor:
        return self._score(logits, cls)

    def indness(self, logits, cls, valid) -> torch.Tensor:
        """Piecewise-linear INDness in [-1, 1] (ood_utils.py:1224-1283)."""
        dev = logits.device
        thr = table_lookup(self.packed_thresholds(dev), cls)
        mx = table_lookup(torch.as_tensor(self.max_score, device=dev), cls)
        mn = table_lookup(torch.as_tensor(self.min_score, device=dev), cls)
        s = self._score(logits, cls)
        pos = (s - thr) / torch.clamp(mx - thr, min=1e-12)
        neg = (s - thr) / torch.clamp(thr - mn, min=1e-12)
        ind = torch.where(s > thr, pos, torch.where(s < thr, neg, torch.zeros_like(s)))
        if CUSTOM_HYP.fusion.CLIP_FUSION_SCORES:
            ind = ind.clamp(-1.0, 1.0)
        return torch.where(valid, ind, torch.zeros_like(ind))


@dataclasses.dataclass
class DistanceOODMethod:
    """Centroid-distance methods with per-(class, stride) clusters and
    thresholds; features are flattened and L2-normalised
    (ood_utils.py:2404-2410)."""

    name: str
    metric: str = "cosine"
    cluster_method: str = "one"
    cluster_optimization_metric: str = "silhouette"
    agg: str = "mean"
    is_distance_method: bool = True
    # 'roi_aligned_ftmaps' | 'ftmaps_and_strides' (same tap) |
    # 'ftmaps_and_strides_exact_pos' (anchor-cell feature vector)
    which_internal_activations: str = "roi_aligned_ftmaps"
    ind_info_creation_option: str = "valid_preds_one_stride"
    clusters: Optional[List[List[np.ndarray]]] = None
    thresholds: Optional[List[List[Optional[float]]]] = None
    min_dist: Optional[np.ndarray] = None
    max_dist: Optional[np.ndarray] = None
    unk_prop_thr: Optional[float] = None
    _banks: Dict[str, CentroidBank] = dataclasses.field(default_factory=dict, repr=False)
    # an SDR method's kind, fitting device and per-stride embedders, and its
    # (sdr_state, acts (N, ...), cls, stride) -> (N, D) embedding (ood/sdr.py)
    sdr_state: Optional[dict] = dataclasses.field(default=None, repr=False)
    transform_fn: Optional[Callable] = dataclasses.field(default=None, repr=False)

    def __getstate__(self):
        # the centroid banks hold tensors on the devices that decided; a
        # pickle (a serving bundle's ood_method.pkl) keeps the host clusters
        # and rebuilds the bank on the serving device at first use
        state = dict(self.__dict__)
        state["_banks"] = {}
        return state

    @staticmethod
    def from_name(name: str, cluster_method: str = "one", **kw) -> "DistanceOODMethod":
        """The method of a distance name; an SDR name gets its transform
        from ``ood/sdr.py:attach_sdr_transform`` (the factory attaches it)."""
        return DistanceOODMethod(name=name, metric=_METRIC_OF[name],
                                 cluster_method=cluster_method, **kw)

    def transform(self, acts: np.ndarray, cls_idx: int = 0, stride_idx: int = 0) -> np.ndarray:
        """Flattened, L2-normalised rows, or the SDR embedding when one is
        attached (JAX methods.py:236-240)."""
        if self.transform_fn is not None:
            return self.transform_fn(self.sdr_state, acts, cls_idx, stride_idx)
        flat = np.asarray(acts, np.float32).reshape(len(acts), -1)
        return l2_normalize_rows(torch.as_tensor(flat)).numpy()

    def generate_clusters(self, acts: Sequence[Sequence[np.ndarray]], logger=None,
                          min_samples: Optional[int] = None):
        """acts[class][stride] = (N, ...) activations -> per group with more
        than clusters.MIN_SAMPLES samples (read at call time), the ``agg``
        (mean or median) of its transformed features: one centroid with
        ``one``, else one per label of ``fit_cluster_labels`` in sorted label
        order, -1 skipped under REMOVE_ORPHANS (ood_utils.py:2263-2366). An
        SDR method fits its embedders on the first call (JAX sdr.py:148-166)."""
        if self.sdr_state is not None and self.sdr_state["embedders"] is None:
            self.sdr_state["embedders"] = fit_stride_embedders(
                acts, self.sdr_state["kind"], self.sdr_state["device"])
        if min_samples is None:
            min_samples = CUSTOM_HYP.clusters.MIN_SAMPLES
        agg = np.mean if self.agg == "mean" else np.median
        nc = len(acts)
        clusters = [[np.empty(0) for _ in range(3)] for _ in range(nc)]
        for c in range(nc):
            for s in range(3):
                a = acts[c][s]
                if not isinstance(a, np.ndarray) or a.size == 0 or len(a) <= min_samples:
                    continue
                feats = self.transform(a, c, s)
                if self.cluster_method == "one":
                    clusters[c][s] = agg(feats, axis=0)[None, :]
                    continue
                labels = fit_cluster_labels(feats, self.cluster_method, self.metric,
                                            self.cluster_optimization_metric,
                                            tag=f"{self.name}_cls{c}_stride{s}")
                cents = [agg(feats[labels == lab], axis=0)
                         for lab in sorted(set(labels.tolist()))
                         if not (lab == -1 and CUSTOM_HYP.clusters.REMOVE_ORPHANS)]
                if cents:
                    clusters[c][s] = np.stack(cents, axis=0)
        self.clusters = clusters
        self._banks = {}
        return clusters

    def bank(self, device="cpu") -> CentroidBank:
        """The padded centroid bank on ``device`` (built once per device).
        Strides' dims are zero-padded to the widest (l1/l2/cosine are
        padding-invariant); cosine centroids are normalised here, because
        kernel K3 computes 1 - x.c on unit rows (ood/methods.py:300-314)."""
        key = str(device)
        if key not in self._banks:
            dims = [c.shape[-1] for row in self.clusters for c in row
                    if isinstance(c, np.ndarray) and c.ndim == 2]
            d = max(dims) if dims else 1

            def prep(c):
                if not (isinstance(c, np.ndarray) and c.ndim == 2):
                    return c
                c = np.pad(c, ((0, 0), (0, d - c.shape[-1])))
                if self.metric == "cosine":
                    c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
                return c

            padded = [[prep(c) for c in row] for row in self.clusters]
            self._banks[key] = build_centroid_bank(padded, d, device=device)
        return self._banks[key]

    def compute_scores_from_activations(self, acts) -> List[List[np.ndarray]]:
        """InD distances per (class, stride) (ood_utils.py:1877-2036)."""
        nc = len(acts)
        scores = [[np.empty(0) for _ in range(3)] for _ in range(nc)]
        for c in range(nc):
            for s in range(3):
                a, cl = acts[c][s], self.clusters[c][s]
                if (not isinstance(a, np.ndarray)) or a.size == 0 or \
                        (not isinstance(cl, np.ndarray)) or cl.size == 0:
                    continue
                d = pairwise_distance(_cpu(cl), _cpu(self.transform(a, c, s)), self.metric)
                scores[c][s] = d.numpy().min(axis=0)
        self.min_dist = np.array(
            [[s.min() if s.size else 0.0 for s in row] for row in scores], np.float32)
        self.max_dist = np.array(
            [[s.max() if s.size else 0.0 for s in row] for row in scores], np.float32)
        return scores

    def generate_thresholds(self, ind_scores, tpr: float):
        self.thresholds = generate_thresholds_per_class_per_stride(
            ind_scores, tpr, is_distance=True)
        return self.thresholds

    def generate_unk_prop_thr(self, acts, tpr: float, rank_op: str = "entropy"):
        """The threshold that gates EUL's unknown proposals: a percentile
        ('lower') of the rank-reduced distances of the InD stride-0
        activations to every class's stride-0 clusters (reference
        ood_utils.py:1917-2023)."""
        from .unknown import rank_distances

        all_scores = []
        for c, per_cls in enumerate(acts):
            a = per_cls[0]
            if not isinstance(a, np.ndarray) or a.size == 0:
                continue
            feats = _cpu(self.transform(a, c, 0))
            rows = [pairwise_distance(_cpu(cl), feats, self.metric).numpy().min(axis=0)
                    for cl in (row[0] for row in self.clusters)
                    if isinstance(cl, np.ndarray) and cl.ndim == 2 and cl.size]
            if rows:
                all_scores.append(rank_distances(np.stack(rows), rank_op))
        if not all_scores:
            self.unk_prop_thr = None
            return None
        scores = np.concatenate(all_scores)
        self.unk_prop_thr = float(np.percentile(scores, 100 * tpr, method="lower"))
        return self.unk_prop_thr

    def packed_thresholds(self, device="cpu") -> torch.Tensor:
        return torch.as_tensor(pack_thresholds_per_class_per_stride(self.thresholds),
                               device=device)

    def _padded(self, feats: torch.Tensor):
        """(feats, bank) zero-padded to a common feature width (l1, l2 and
        cosine are padding-invariant)."""
        bank = self.bank(feats.device)
        d_f, d_b = feats.shape[-1], bank.centroids.shape[-1]
        if d_f < d_b:
            feats = torch.nn.functional.pad(feats, (0, d_b - d_f))
        elif d_b < d_f:
            bank = bank._replace(centroids=torch.nn.functional.pad(
                bank.centroids, (0, d_f - d_b)))
        return feats, bank

    def group_inputs(self, feats: torch.Tensor):
        """The arguments :func:`min_group_distances` gets for these (N, D)
        features: (feats f32, centroids (nc*S, Kmax, D), kmask (nc*S, Kmax)).
        bf16 features are normalised in bf16 and then upcast, where the JAX
        package's distance promotes them against the f32 bank."""
        feats, bank = self._padded(feats)
        if self.metric == "cosine":
            # sklearn cosine normalises both sides; K3 assumes unit rows
            feats = l2_normalize_rows(feats)
        nc, s, kmax, dd = bank.centroids.shape
        groups = bank.centroids.reshape(nc * s, kmax, dd).contiguous()
        kmask = torch.arange(kmax, device=feats.device)[None, :] < bank.count.reshape(-1)[:, None]
        return feats.float().contiguous(), groups, kmask

    def distances(self, feats: torch.Tensor, cls: torch.Tensor,
                  stride_idx: torch.Tensor) -> torch.Tensor:
        """(N, D) transformed feats -> (N,) min centroid distance."""
        if self.metric not in ("cosine", "l2", "euclidean"):
            feats, bank = self._padded(feats.float())
            return min_distance_to_class_centroids(feats, cls, stride_idx, bank, self.metric)
        dmat = min_group_distances(*self.group_inputs(feats), self.metric)
        s = self.bank(feats.device).centroids.shape[1]
        gidx = (cls.long() * s + stride_idx.long())[:, None]
        dmin = torch.gather(dmat, 1, gidx)[:, 0]
        return torch.where(torch.isfinite(dmin), dmin, torch.full_like(dmin, NO_CLUSTER_DISTANCE))

    def decide_from_distances(self, dist, cls, stride_idx, valid) -> torch.Tensor:
        thr = table_lookup(self.packed_thresholds(dist.device), cls, stride_idx)
        ind = (dist < thr) & ~torch.isnan(thr)
        return torch.where(valid, ind.int(), torch.zeros_like(ind, dtype=torch.int32))

    def indness_from_distances(self, dist, cls, stride_idx, valid) -> torch.Tensor:
        """Distance INDness (ood_utils.py:1584-1650), all reference modes."""
        fus = CUSTOM_HYP.fusion
        dev = dist.device
        thr = table_lookup(self.packed_thresholds(dev), cls, stride_idx)
        if fus.DISTANCE_USE_FROM_ZERO_TO_THR:
            den = thr - 1.0
            degenerate = torch.abs(den) < 1e-9
            a = -1.0 / torch.where(degenerate, torch.ones_like(den), den)
            ind = torch.where(degenerate, torch.full_like(dist, -1.0), a * dist + (1.0 - a))
        elif fus.DISTANCE_INDNESS_REFERENCE_QUIRK:
            ind = torch.full_like(dist, -1.0)
        else:
            mx = table_lookup(torch.as_tensor(self.max_dist, device=dev), cls, stride_idx)
            mn = table_lookup(torch.as_tensor(self.min_dist, device=dev), cls, stride_idx)
            above = -(dist - thr) / torch.clamp(mx - thr, min=1e-12)
            below = (thr - dist) / torch.clamp(thr - mn, min=1e-12)
            ind = torch.where(dist > thr, above,
                              torch.where(dist < thr, below, torch.zeros_like(dist)))
        if fus.CLIP_FUSION_SCORES:
            ind = ind.clamp(-1.0, 1.0)
        ind = torch.where(torch.isnan(thr), torch.full_like(ind, -1.0), ind)
        return torch.where(valid, ind, torch.zeros_like(ind))


def fuse_decisions(strategy: str, *decisions: torch.Tensor) -> torch.Tensor:
    """Fuse 1=InD/0=OoD masks or INDness scores (ood_utils.py:2906-2940;
    majority vote for 3 methods, ood_utils.py:3282-3301)."""
    d = torch.stack(decisions, dim=0)
    n = d.shape[0]
    if strategy == "and":
        return d.amax(dim=0)
    if strategy == "or":
        return d.amin(dim=0)
    if strategy == "score":
        return (d.sum(dim=0) > 0).int()
    if strategy == "vote":
        return (d.sum(dim=0) >= (n // 2 + 1)).int()
    raise ValueError(f"unknown fusion strategy {strategy}")


@dataclasses.dataclass
class FusionOODMethod:
    """Two or three methods fused by and/or/score/vote, all from one
    forward pass."""

    methods: Sequence[object]
    strategy: str = "and"
    name: str = "fusion"

    @property
    def is_distance_method(self) -> bool:
        return any(getattr(m, "is_distance_method", False) for m in self.methods)

    def fuse(self, member_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
        return fuse_decisions(self.strategy, *member_outputs)
