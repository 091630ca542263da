"""End-to-end OoD pipeline: InD extraction -> fit -> evaluate.

Port of ood_in_object_detection_tpu/ood/pipeline.py as a serial host loop
around ``Detector.predict``:

- ``extract_ind_activations``: per batch, predict at conf_thr_train,
  Hungarian-match predictions to targets (ood_utils.py:233-292) and bucket
  the matched boxes' taps per class (logits) or per (class, stride) (neck
  features, 'valid_preds_one_stride' by default).
- ``fit_ind_pipeline``: clusters -> InD scores -> thresholds (and the
  unknown-proposal threshold when it gates EUL) (reference
  ood_evaluation.py:398-644).
- ``evaluate_method``: per batch decide InD/OoD, relabel OoD boxes as the
  unknown class, optionally append enhanced unknown localisation (EUL)
  proposals as unknowns, and run the OWOD protocol (ood_utils.py:428-582).
  EUL's front end runs on P3's device (``unknown.eul_frontend_batched``),
  connected components and selection on the host, and the proposals' rank
  on the device: their 1x1 RoIAlign on P3 (kernel K2) and their distances
  to the classes' stride-0 centroids (kernel K3).
- ``collect_fusion_member_indness``: per-box INDness of each fusion member
  (the CLI's --dump_fusion_scores).

With CUSTOM_HYP.BENCHMARK_MODE on, ``evaluate_method`` keeps each batch's
post-NMS per-box tensors (and P3 when EUL needs it) in a host-side cache on
disk, so that a sweep over post-prediction knobs runs the forward once per
batch (``_cached_predict``).

The SDR methods' embeddings (``ood/sdr.py``) run inside
``distance_features``, on the taps' device.

With a ``mesh`` (parallel/mesh.py) every batch is predicted data parallel
by ``Detector.predict_sharded``: a replica a device, the outputs gathered
onto the mesh's first device, where the decisions (K3) and EUL run.

Not ported yet: the launch/consume overlap (it relies on JAX's
asynchronous dispatch).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..core.config import CUSTOM_HYP
from ..engine import Detector, PredictOutput
from ..eval.owod_protocol import UNKNOWN_CLASS_INDEX, compute_metrics
from ..ops.nms import Detections
from ..ops.roi_align import all_level_roi, roi_align_1x1_batched_level
from .distance import (PAIRWISE_METRICS, CentroidBank, build_centroid_bank,
                       distances_to_all_class_centroids_stride0, l2_normalize_rows,
                       pairwise_distance)
from .matching import match_predictions_to_targets
from .methods import DistanceOODMethod, FusionOODMethod, LogitsOODMethod
from .scores import table_lookup
from .sdr import sdr_embeddings
from .thresholds import pack_thresholds_per_class_per_stride
from .unknown import (eul_frontend_batched, finish_unknown_proposals, rank_distances,
                      unknown_candidates_for_image)

log = logging.getLogger(__name__)

UNK_PROPOSAL_CONF = 0.150001  # reference ood_utils.py:530
# one per process: a sweep's combos share cache entries, another run (other
# weights) never reads them (the reference's f"{NOW}_..." key, ood_utils.py:477)
_CACHE_NONCE = f"{os.getpid():x}-{int(time.time()):x}"


def _np(x) -> np.ndarray:
    """A host array; bf16 taps become f32 (the same values), where the JAX
    package keeps bf16 host arrays and converts them to f32 before use
    (ood/methods.py:239, 339, 372)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _to(x, device):
    """Every tensor of a (nested) tuple on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(_to(v, device) for v in x)) if hasattr(x, "_fields") else \
        tuple(_to(v, device) for v in x)


def _cached_predict(step, device, batches, conf_thr_test: float, eul: bool):
    """``(batch_idx, images) -> PredictOutput``: ``step`` alone, or under
    CUSTOM_HYP.BENCHMARK_MODE a cache on disk (JAX ood/pipeline.py:392-427,
    reference ood_utils.py:450-482). An entry is keyed by the process nonce,
    the dataset's tag (``batches.tag``), the test confidence and EUL, and
    holds the per-box tensors on the host (and P3 with EUL, not the other
    neck maps); a hit returns them as a PredictOutput on ``device`` (where
    the step's outputs lie) without running the forward."""
    if not CUSTOM_HYP.BENCHMARK_MODE:
        return lambda batch_idx, images: step(images)
    cache_dir = C.TEMPORAL_STORAGE_PATH
    cache_dir.mkdir(parents=True, exist_ok=True)
    tag = (f"{_CACHE_NONCE}_{getattr(batches, 'tag', 'ds')}_conf{conf_thr_test}"
           + ("_eul" if eul else ""))

    def predict(batch_idx, images):
        path = cache_dir / f"{tag}_{batch_idx}.pkl"
        if path.exists():
            return PredictOutput(*_to(pickle.loads(path.read_bytes()), device))
        out = step(images)
        slim = PredictOutput(out.det, out.logits, out.stride_level, out.anchor_idx,
                             out.roi_feats, out.exact_feats, (out.neck[0],) if eul else ())
        path.write_bytes(pickle.dumps(tuple(_to(slim, "cpu"))))
        return out

    return predict


def _predict_step(detector: Detector, conf_thres: float, mesh=None, **kw):
    """``images -> PredictOutput``; with a ``mesh``, data parallel through
    ``Detector.predict_sharded`` (JAX pipeline.py:56-72). NMS IoU defaults
    to 0.7, the ultralytics default the reference's pipeline inherits
    (cfg/default.yaml:57) — not CUSTOM_HYP.IOU_THRESHOLD, which is the
    pred-to-GT matching threshold."""
    kw.setdefault("iou_thres", 0.7)
    if mesh is None:
        return lambda images: detector.predict(images, conf_thres=conf_thres, **kw)
    return lambda images: detector.predict_sharded(images, mesh, conf_thres=conf_thres, **kw)


def _leaf_methods(method) -> List[object]:
    if isinstance(method, FusionOODMethod):
        return [leaf for m in method.methods for leaf in _leaf_methods(m)]
    return [method]


def assign_fitted_state(method, thresholds=None, clusters=None) -> List[object]:
    """Restore pickled per-leaf fit artifacts onto a freshly built method
    tree, in factory order (``None`` entries keep the leaf's state)."""
    leaves = _leaf_methods(method)
    if clusters is not None:
        if len(clusters) != len(leaves):
            raise ValueError(f"{len(clusters)} cluster entries for {len(leaves)} leaves")
        for m, cl in zip(leaves, clusters):
            if isinstance(m, DistanceOODMethod) and cl is not None:
                m.clusters = cl
                m._banks = {}
    if thresholds is not None:
        if len(thresholds) != len(leaves):
            raise ValueError(f"{len(thresholds)} threshold entries for {len(leaves)} leaves")
        for m, t in zip(leaves, thresholds):
            if t is not None:
                m.thresholds = t
    return leaves


def _size_to_level(box_xyxy: np.ndarray, img_w: int) -> int:
    """FPN-style level of a target box by its size (reference
    constants.py:37): small -> P3, medium -> P4, large -> P5."""
    side = float(np.sqrt(max(box_xyxy[2] - box_xyxy[0], 0) *
                         max(box_xyxy[3] - box_xyxy[1], 0)))
    if side < img_w / 8:
        return 0
    if side < img_w / 4:
        return 1
    return 2


def _target_roi_feats(out: PredictOutput, tgt_boxes_xyxy: np.ndarray, img_w: int,
                      image_index: int) -> List[np.ndarray]:
    """3 x (M, C_s) RoI features of one image's ground-truth boxes."""
    boxes = torch.as_tensor(np.asarray(tgt_boxes_xyxy, np.float32), device=out.neck[0].device)
    return [_np(roi_align_1x1_batched_level(f[image_index][None], boxes[None],
                                            f.shape[2] / img_w, samples=0)[0])
            for f in out.neck]


def extract_ind_activations(detector: Detector, batches, method,
                            conf_thr_train: float = 0.15,
                            iou_thr_matching: Optional[float] = None,
                            mesh=None) -> Dict[int, object]:
    """-> {id(leaf): activations} for every leaf method in one pass. Logits
    leaves get [class] -> (N, nc) logits; distance leaves get
    [class][stride] -> (N, C_stride) neck features. With a ``mesh``, each
    batch is predicted over it (``_predict_step``)."""
    iou_thr = CUSTOM_HYP.IOU_THRESHOLD if iou_thr_matching is None else iou_thr_matching
    nc = detector.nc
    neck_ch = detector.neck_channels()
    leaves = _leaf_methods(method)
    acc: Dict[int, object] = {
        id(m): [[] for _ in range(nc)] if isinstance(m, LogitsOODMethod)
        else [[[] for _ in range(3)] for _ in range(nc)] for m in leaves}

    step = _predict_step(detector, conf_thr_train, mesh)
    img_w = detector.img_size
    for batch in batches:
        out = step(batch["images"])
        boxes, cls, valid = _np(out.det.boxes), _np(out.det.cls), _np(out.det.valid)
        logits, level = _np(out.logits), _np(out.stride_level)
        roi, exact = _np(out.roi_feats), _np(out.exact_feats)
        bmask = batch.get("batch_mask", np.ones(len(boxes), bool))
        all_stride = None  # every box at every stride, computed on first need
        for i in range(len(boxes)):
            if not bmask[i]:
                continue
            n = int(valid[i].sum())
            tgt_m = batch["gt_mask"][i]
            tgt_b = batch["gt_bboxes"][i][tgt_m]
            tgt_c = batch["gt_labels"][i][tgt_m]
            matched = []
            if n > 0:
                matched = match_predictions_to_targets(
                    boxes[i, :n], cls[i, :n].astype(np.float64),
                    tgt_b, tgt_c.astype(np.float64), iou_thr)
            for m in leaves:
                a = acc[id(m)]
                if isinstance(m, LogitsOODMethod):
                    for j in matched:
                        a[int(cls[i, j])].append(logits[i, j])
                    continue
                opt = m.ind_info_creation_option
                exact_pos = m.which_internal_activations == "ftmaps_and_strides_exact_pos"
                if opt == "valid_preds_one_stride":
                    for j in matched:
                        s = int(level[i, j])
                        a[int(cls[i, j])][s].append((exact if exact_pos else roi)[i, j, : neck_ch[s]])
                elif opt in ("all_preds_all_strides", "valid_preds_all_strides"):
                    if all_stride is None:
                        all_stride = [_np(f) for f in all_level_roi(out.neck, out.det.boxes, img_w)]
                    for j in (matched if opt == "valid_preds_all_strides" else range(n)):
                        for s in range(3):
                            a[int(cls[i, j])][s].append(all_stride[s][i, j, : neck_ch[s]])
                elif opt in ("all_targets_one_stride", "all_targets_all_strides"):
                    if len(tgt_b) == 0:
                        continue
                    tgt_roi = _target_roi_feats(out, tgt_b, img_w, image_index=i)
                    for t in range(len(tgt_b)):
                        c = int(tgt_c[t])
                        if not 0 <= c < nc:
                            continue  # unknown-class GT on an unfiltered set
                        strides = (range(3) if opt == "all_targets_all_strides"
                                   else [_size_to_level(tgt_b[t], img_w)])
                        for s in strides:
                            a[c][s].append(tgt_roi[s][t])
                else:
                    raise ValueError(f"unknown ind_info_creation_option {opt}")

    for m in leaves:
        a = acc[id(m)]
        if isinstance(m, LogitsOODMethod):
            acc[id(m)] = [np.stack(x) if x else np.empty((0, nc), np.float32) for x in a]
        else:
            acc[id(m)] = [[np.stack(x) if x else np.empty(0, np.float32) for x in row]
                          for row in a]
    return acc


def fit_ind_pipeline(method, activations: Dict[int, object], tpr: float = 0.95,
                     logger=None) -> None:
    """Clusters (distance) -> InD scores -> thresholds for every leaf."""
    for m in _leaf_methods(method):
        acts = activations[id(m)]
        if isinstance(m, DistanceOODMethod):
            m.generate_clusters(acts)
        m.generate_thresholds(m.compute_scores_from_activations(acts), tpr)
        if isinstance(m, DistanceOODMethod) and CUSTOM_HYP.unk.rank.USE_UNK_PROPOSALS_THR:
            m.generate_unk_prop_thr(acts, tpr, CUSTOM_HYP.unk.rank.RANK_BOXES_OPERATION)


def distance_features(method: DistanceOODMethod, out: PredictOutput, neck_ch):
    """(B*N, Cmax) L2-normalised box features with channels beyond each
    box's stride width zeroed, plus the flat classes and levels. The
    features keep the taps' dtype, as in the JAX package (bf16 under
    --bf16); the distance upcasts them (methods.py:distances). A fitted SDR
    method's features are its (B*N, out_dim) f32 embeddings instead
    (``sdr.sdr_embeddings``, JAX pipeline.py:333-350)."""
    base = (out.exact_feats if method.which_internal_activations == "ftmaps_and_strides_exact_pos"
            else out.roi_feats)
    cmax = base.shape[-1]
    ch = table_lookup(torch.as_tensor(neck_ch, device=base.device), out.stride_level)
    chmask = torch.arange(cmax, device=base.device)[None, None, :] < ch[..., None]
    feats = torch.where(chmask, base, torch.zeros_like(base))
    flat = l2_normalize_rows(feats.reshape(-1, cmax))
    level = out.stride_level.reshape(-1)
    emb = sdr_embeddings(method, flat, level)
    return (flat if emb is None else emb), out.det.cls.reshape(-1), level


def _decisions_for_method(method, out: PredictOutput, neck_ch,
                          want_scores: bool = False, raw: bool = False) -> torch.Tensor:
    """(B, max_det) per-box decision (default), INDness in [-1, 1]
    (want_scores) or threshold-free raw score (raw; higher = more InD)."""
    det = out.det
    if isinstance(method, FusionOODMethod):
        if raw:
            raise ValueError("raw scores are per-member; fuse INDness instead")
        if want_scores:
            stacked = torch.stack([_decisions_for_method(m, out, neck_ch, True)
                                   for m in method.methods])
            if method.strategy == "and":
                return stacked.amax(dim=0)
            if method.strategy == "or":
                return stacked.amin(dim=0)
            if method.strategy == "score":
                return stacked.sum(dim=0)
            return stacked.mean(dim=0)  # vote
        member = [_decisions_for_method(m, out, neck_ch, method.strategy == "score")
                  for m in method.methods]
        return method.fuse(member)
    if isinstance(method, LogitsOODMethod):
        if raw:
            return method.raw_scores(out.logits, det.cls)
        fn = method.indness if want_scores else method.decide
        return fn(out.logits, det.cls, det.valid)
    flat, cls, level = distance_features(method, out, neck_ch)
    dist = method.distances(flat, cls, level).reshape(det.cls.shape)
    if raw:
        return -dist
    fn = method.indness_from_distances if want_scores else method.decide_from_distances
    return fn(dist, det.cls, out.stride_level, det.valid)


def evaluate_method(detector: Detector, batches, method, known_classes: Sequence[int],
                    class_names: Sequence[str], conf_thr_test: float = 0.15,
                    enhanced_unk_localization: bool = False, logger=None,
                    visualize_dir: Optional[str] = None, visualize_batches: int = 2,
                    mesh=None) -> Dict[str, float]:
    """Full metric loop (reference ood_utils.py:428-582), one batch at a
    time; OoD boxes are relabelled as the unknown class. With
    ``enhanced_unk_localization`` each image also gets the EUL proposals of
    the first distance method, as unknowns at confidence UNK_PROPOSAL_CONF
    (ood_utils.py:526-532). With a ``mesh``, each batch is predicted over
    it and decided on its first device."""
    logger = logger or log
    neck_ch = detector.neck_channels()
    device = detector.device if mesh is None else mesh.batch_devices[0]  # the outputs'
    predict = _cached_predict(_predict_step(detector, conf_thr_test, mesh), device, batches,
                              conf_thr_test, enhanced_unk_localization)
    all_preds, all_targets = [], []
    known_arr = np.asarray(list(known_classes))
    if enhanced_unk_localization:
        dms = [m for m in _leaf_methods(method) if isinstance(m, DistanceOODMethod)]
        if not dms:
            raise ValueError("EUL needs a distance method (it ranks by centroid distance)")
        dm = dms[0]
        rank_bank = _stride0_rank_bank(dm, neck_ch[0], device)
    for batch_idx, batch in enumerate(batches):
        out = predict(batch_idx, batch["images"])
        decisions = _np(_decisions_for_method(method, out, neck_ch))
        if visualize_dir and batch_idx < visualize_batches:
            from ..utils.visualization import plot_batch_results

            plot_batch_results(batch, SimpleNamespace(det=Detections(*map(_np, out.det))),
                               decisions, list(class_names), visualize_dir,
                               prefix=f"b{batch_idx}_")
        boxes, confs = _np(out.det.boxes), _np(out.det.conf)
        cls, valid = _np(out.det.cls), _np(out.det.valid)
        bmask = batch.get("batch_mask", np.ones(len(boxes), bool))
        eul = {}
        if enhanced_unk_localization:
            pred_by_img = {i: boxes[i, : int(valid[i].sum())].astype(np.float64)
                           for i in range(len(boxes)) if bmask[i]}
            eul = eul_proposals_batch(dm, rank_bank, out.p3, batch["ratio_pad"], pred_by_img)
        for i in range(len(boxes)):
            if not bmask[i]:
                continue
            n = int(valid[i].sum())
            b = boxes[i, :n].astype(np.float64)
            c = cls[i, :n].astype(np.float64)
            c = np.where(decisions[i, :n] == 0, float(UNKNOWN_CLASS_INDEX), c)
            f = confs[i, :n].astype(np.float64)
            props = eul[i][0] if i in eul else ()
            if len(props):
                b = np.concatenate([b, props.astype(np.float64)])
                c = np.concatenate([c, np.full(len(props), float(UNKNOWN_CLASS_INDEX))])
                f = np.concatenate([f, np.full(len(props), UNK_PROPOSAL_CONF)])
            all_preds.append(dict(img_name=batch["im_names"][i], bboxes=b, cls=c, conf=f))
            tgt_m = batch["gt_mask"][i]
            tcls = batch["gt_labels"][i][tgt_m].astype(np.float64)
            tcls = np.where(np.isin(tcls, known_arr), tcls, float(UNKNOWN_CLASS_INDEX))
            all_targets.append(dict(img_name=batch["im_names"][i],
                                    bboxes=batch["gt_bboxes"][i][tgt_m].astype(np.float64),
                                    cls=tcls))
    return compute_metrics(all_preds, all_targets, list(class_names),
                           list(known_classes), logger)


def _rank_from_matrix(mat: np.ndarray, row_cls: np.ndarray):
    """Reduce a (n_valid_classes, n_props) min-distance matrix per the
    configured rank op (reference ood_utils.py:1056-1092); the gated 'min'
    gives the raw minimum (no x100) and the closest class id."""
    op = CUSTOM_HYP.unk.rank.RANK_BOXES_OPERATION
    if op == "min" and CUSTOM_HYP.unk.rank.USE_OOD_THR_TO_REMOVE_PROPS:
        return mat.min(axis=0), np.asarray(row_cls)[mat.argmin(axis=0)]
    return rank_distances(mat, op)


def _make_rank_fn(dm: DistanceOODMethod, p3_img: torch.Tensor):
    """Per-image rank fn over one (H, W, C) map, for stride-0 clusters that
    ``_stride0_rank_bank`` refuses (none at all gives zeros): proposals in
    padded-ftmap cells -> 1x1 RoIAlign on the map -> L2-normalised (an SDR
    method: its transform, on the host, JAX pipeline.py:607-608) ->
    distance to each class's stride-0 clusters -> ``_rank_from_matrix``."""
    def fn(props_ftmap: np.ndarray):
        boxes = torch.as_tensor(np.asarray(props_ftmap, np.float32), device=p3_img.device)
        feats = roi_align_1x1_batched_level(p3_img.float().contiguous()[None], boxes[None],
                                            1.0, samples=4)[0]
        if dm.transform_fn is not None:  # the same for every class: stride 0's embedder
            tf = torch.as_tensor(dm.transform(_np(feats), 0, 0), device=feats.device)
        else:
            tf = l2_normalize_rows(feats)
        rows, row_cls = [], []
        for c, per_cls in enumerate(dm.clusters):
            cl = per_cls[0]
            if isinstance(cl, np.ndarray) and cl.ndim == 2 and cl.size:
                cents = torch.as_tensor(np.asarray(cl, np.float32), device=tf.device)
                rows.append(_np(pairwise_distance(cents, tf, dm.metric)).min(axis=0))
                row_cls.append(c)
        if not rows:
            return np.zeros(len(props_ftmap), np.float32)
        return _rank_from_matrix(np.stack(rows), np.asarray(row_cls))

    return fn


def _stride0_rank_bank(dm: DistanceOODMethod, p3_channels: int, device):
    """(the classes' stride-0 centroids as a one-stride bank on ``device``,
    the valid class ids as a tensor there) for the batched rank, or None
    when the method's stride-0 clusters cannot feed it (none, an SDR
    transform, or a width other than P3's channel count)."""
    if dm.transform_fn is not None or dm.metric not in PAIRWISE_METRICS:
        return None
    rows = [c for c, per_cls in enumerate(dm.clusters)
            if isinstance(per_cls[0], np.ndarray) and per_cls[0].ndim == 2 and per_cls[0].size]
    if not rows:
        return None
    d0 = dm.clusters[rows[0]][0].shape[1]
    if d0 != p3_channels or any(dm.clusters[c][0].shape[1] != d0 for c in rows):
        return None
    bank = build_centroid_bank([[per_cls[0]] for per_cls in dm.clusters], d0, num_strides=1,
                               device=device)
    return bank, torch.as_tensor(rows, device=device)


def rank_reduce_batched(p3: torch.Tensor, props: torch.Tensor, bank: CentroidBank,
                        rows: torch.Tensor, metric: str, op: str, gated: bool):
    """Rank scores (B, n) of proposals (B, n, 4) in padded-ftmap cells on the
    (B, H, W, C) map, and with the gated 'min' the closest class ids:
    each proposal's 1x1 RoIAlign on the map (4 x 4 samples, kernel K2; a
    bf16 map is upcast, as JAX's bilinear taps compute in f32), its
    L2-normalised feature's distances to every class's stride-0 centroids
    (kernel K3), the valid classes' columns reduced per ``op``
    (reference ood_utils.py:1056-1092; ``rank_distances``' formulas)."""
    feats = roi_align_1x1_batched_level(p3.float().contiguous(), props, 1.0, samples=4)
    b, n, c = feats.shape
    tf = l2_normalize_rows(feats.reshape(b * n, c))
    sub = distances_to_all_class_centroids_stride0(tf, bank, metric).reshape(b, n, -1)[:, :, rows]
    if op == "min" and gated:
        vals, idx = sub.min(dim=-1)
        return vals, rows[idx]
    if op == "min":
        return sub.amin(dim=-1) * 100  # reference compensation (:1078)
    if op == "mean":
        return sub.mean(dim=-1)
    if op == "max":
        return sub.amax(dim=-1)
    if op == "sum":
        return sub.sum(dim=-1)
    if op == "geometric_mean":
        return torch.exp(torch.log(sub).mean(dim=-1))
    if op == "entropy":
        p = sub / sub.sum(dim=-1, keepdim=True)
        return -torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)).sum(dim=-1)
    raise NotImplementedError(op)


def eul_proposals_batch(dm: DistanceOODMethod, rank_bank, p3: torch.Tensor, ratio_pads,
                        pred_boxes_by_img: Dict[int, np.ndarray]) -> Dict[int, tuple]:
    """EUL for one batch -> {image: (proposals xyxy in image pixels, decisions
    (all 0 = unknown), rank scores or None)}.

    The front end on P3's device (``eul_frontend_batched``; the host
    summarizer and thresholder where the configuration has no device
    path), connected components and heuristics on the host for every image,
    ONE batched rank on the device (``rank_reduce_batched``; per-image
    ``_make_rank_fn`` where the bank was refused), then per-image
    selection (reference ood_utils.py:641-1174)."""
    hyp = CUSTOM_HYP.unk
    padded_hw = tuple(p3.shape[1:3])
    fe = eul_frontend_batched(p3, ratio_pads)
    p3_host = _np(p3) if fe is None else None
    cand = {i: unknown_candidates_for_image(
                None if fe is not None else p3_host[i], ratio_pads[i], pb,
                precomputed=fe[i] if fe is not None else None, padded_hw=padded_hw)
            for i, pb in pred_boxes_by_img.items()}
    ranks = {}
    nmax = max((len(c) for c in cand.values()), default=0)
    if hyp.USE_HEURISTICS and hyp.RANK_BOXES and nmax:
        if rank_bank is None:
            ranks = {i: _make_rank_fn(dm, p3[i])(c) for i, c in cand.items() if len(c)}
        else:
            props = np.zeros((p3.shape[0], nmax, 4), np.float32)
            for i, c in cand.items():
                props[i, : len(c)] = c
            gated = bool(hyp.rank.USE_OOD_THR_TO_REMOVE_PROPS)
            red = rank_reduce_batched(p3, torch.as_tensor(props, device=p3.device), *rank_bank,
                                      dm.metric, hyp.rank.RANK_BOXES_OPERATION, gated)
            if isinstance(red, tuple):
                scores, closest = _np(red[0]), _np(red[1])
                ranks = {i: (scores[i, : len(c)], closest[i, : len(c)])
                         for i, c in cand.items() if len(c)}
            else:
                scores = _np(red)
                ranks = {i: scores[i, : len(c)] for i, c in cand.items() if len(c)}
    cls_thr = None
    if hyp.rank.USE_OOD_THR_TO_REMOVE_PROPS and dm.thresholds is not None:
        # stride 0; an unfit class gets no gate
        cls_thr = np.nan_to_num(np.asarray(
            pack_thresholds_per_class_per_stride(dm.thresholds))[:, 0], nan=np.inf)
    return {i: finish_unknown_proposals(c, ranks.get(i), unk_prop_thr=dm.unk_prop_thr,
                                        class_thresholds=cls_thr)
            for i, c in cand.items()}


def collect_fusion_member_indness(detector: Detector, batches, fusion,
                                  conf_thr_test: float = 0.15, mesh=None) -> Dict[str, np.ndarray]:
    """Per-box INDness of every member of a fitted fusion method and the
    fused decision, over all valid boxes (the score-fusion figure of the
    reference's score_fusion_plot.ipynb) -> {'member_names', 'indness'
    (M, N), 'decision' (N,), 'cls' (N,), 'conf' (N,)}. With a ``mesh``, each
    batch is predicted over it."""
    if not isinstance(fusion, FusionOODMethod):
        raise ValueError("collect_fusion_member_indness needs a fusion method")
    neck_ch = detector.neck_channels()
    step = _predict_step(detector, conf_thr_test, mesh)
    per_member: List[List[np.ndarray]] = [[] for _ in fusion.methods]
    dec_all, cls_all, conf_all = [], [], []
    for batch in batches:
        out = step(batch["images"])
        member = [_np(_decisions_for_method(m, out, neck_ch, want_scores=True))
                  for m in fusion.methods]
        fused = _np(_decisions_for_method(fusion, out, neck_ch))
        valid = _np(out.det.valid)
        keep = valid & batch.get("batch_mask", np.ones(len(valid), bool))[:, None]
        for mi, arr in enumerate(member):
            per_member[mi].append(arr[keep])
        dec_all.append(fused[keep])
        cls_all.append(_np(out.det.cls)[keep])
        conf_all.append(_np(out.det.conf)[keep])
    return {
        "member_names": np.asarray([m.name for m in fusion.methods]),
        "indness": np.stack([np.concatenate(x) for x in per_member]),
        "decision": np.concatenate(dec_all),
        "cls": np.concatenate(cls_all),
        "conf": np.concatenate(conf_all),
    }
