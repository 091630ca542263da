"""End-to-end OoD pipeline: InD extraction -> fit -> evaluate.

Port of ood_in_object_detection_tpu/ood/pipeline.py as a serial host loop
around ``Detector.predict``:

- ``extract_ind_activations``: per batch, predict at conf_thr_train,
  Hungarian-match predictions to targets (ood_utils.py:233-292) and bucket
  the matched boxes' taps per class (logits) or per (class, stride) (neck
  features, 'valid_preds_one_stride' by default).
- ``fit_ind_pipeline``: clusters -> InD scores -> thresholds
  (reference ood_evaluation.py:398-644).
- ``evaluate_method``: per batch decide InD/OoD, relabel OoD boxes as the
  unknown class, and run the OWOD protocol (ood_utils.py:428-582).

Not ported yet, and each raises when asked for: the launch/consume overlap
(it relies on JAX's asynchronous dispatch), the BENCHMARK_MODE prediction
cache, device meshes, enhanced unknown localisation (EUL) and SDR.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import CUSTOM_HYP
from ..engine import Detector, PredictOutput
from ..eval.owod_protocol import UNKNOWN_CLASS_INDEX, compute_metrics
from ..ops.nms import Detections
from ..ops.roi_align import all_level_roi, roi_align_1x1_batched_level
from .distance import l2_normalize_rows
from .matching import match_predictions_to_targets
from .methods import DistanceOODMethod, FusionOODMethod, LogitsOODMethod
from .scores import table_lookup

log = logging.getLogger(__name__)


def _np(x) -> np.ndarray:
    """A host array; bf16 taps become f32 (the same values), where the JAX
    package keeps bf16 host arrays and converts them to f32 before use
    (ood/methods.py:239, 339, 372)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _check_unported(mesh=None, enhanced_unk_localization: bool = False) -> None:
    if mesh is not None:
        raise NotImplementedError("device meshes are not ported (ROADMAP.md A12, multi-GPU)")
    if enhanced_unk_localization:
        raise NotImplementedError("enhanced unknown localisation is not ported (ROADMAP.md A7)")
    if CUSTOM_HYP.BENCHMARK_MODE:
        raise NotImplementedError("the BENCHMARK_MODE prediction cache is not ported "
                                  "(ROADMAP.md)")


def _predict_step(detector: Detector, conf_thres: float, **kw):
    """``images -> PredictOutput``. NMS IoU defaults to 0.7, the ultralytics
    default the reference's pipeline inherits (cfg/default.yaml:57) — not
    CUSTOM_HYP.IOU_THRESHOLD, which is the pred-to-GT matching threshold."""
    kw.setdefault("iou_thres", 0.7)
    return lambda images: detector.predict(images, conf_thres=conf_thres, **kw)


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
    [class][stride] -> (N, C_stride) neck features."""
    _check_unported(mesh)
    iou_thr = CUSTOM_HYP.IOU_THRESHOLD if iou_thr_matching is None else iou_thr_matching
    nc = detector.nc
    neck_ch = detector.neck_channels()
    leaves = _leaf_methods(method)
    acc: Dict[int, object] = {
        id(m): [[] for _ in range(nc)] if isinstance(m, LogitsOODMethod)
        else [[[] for _ in range(3)] for _ in range(nc)] for m in leaves}

    step = _predict_step(detector, conf_thr_train)
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
    if CUSTOM_HYP.unk.rank.USE_UNK_PROPOSALS_THR:
        raise NotImplementedError("unknown-proposal thresholds belong to EUL (ROADMAP.md A7)")
    for m in _leaf_methods(method):
        acts = activations[id(m)]
        if isinstance(m, DistanceOODMethod):
            m.generate_clusters(acts)
        m.generate_thresholds(m.compute_scores_from_activations(acts), tpr)


def distance_features(method: DistanceOODMethod, out: PredictOutput, neck_ch):
    """(B*N, Cmax) L2-normalised box features with channels beyond each
    box's stride width zeroed, plus the flat classes and levels. The
    features keep the taps' dtype, as in the JAX package (bf16 under
    --bf16); the distance upcasts them (methods.py:distances)."""
    base = (out.exact_feats if method.which_internal_activations == "ftmaps_and_strides_exact_pos"
            else out.roi_feats)
    cmax = base.shape[-1]
    ch = table_lookup(torch.as_tensor(neck_ch, device=base.device), out.stride_level)
    chmask = torch.arange(cmax, device=base.device)[None, None, :] < ch[..., None]
    feats = torch.where(chmask, base, torch.zeros_like(base))
    flat = l2_normalize_rows(feats.reshape(-1, cmax))
    return flat, out.det.cls.reshape(-1), out.stride_level.reshape(-1)


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
    time; OoD boxes are relabelled as the unknown class."""
    _check_unported(mesh, enhanced_unk_localization)
    logger = logger or log
    neck_ch = detector.neck_channels()
    step = _predict_step(detector, conf_thr_test)
    all_preds, all_targets = [], []
    known_arr = np.asarray(list(known_classes))
    for batch_idx, batch in enumerate(batches):
        out = step(batch["images"])
        decisions = _np(_decisions_for_method(method, out, neck_ch))
        if visualize_dir and batch_idx < visualize_batches:
            from ..utils.visualization import plot_batch_results

            plot_batch_results(batch, SimpleNamespace(det=Detections(*map(_np, out.det))),
                               decisions, list(class_names), visualize_dir,
                               prefix=f"b{batch_idx}_")
        boxes, confs = _np(out.det.boxes), _np(out.det.conf)
        cls, valid = _np(out.det.cls), _np(out.det.valid)
        bmask = batch.get("batch_mask", np.ones(len(boxes), bool))
        for i in range(len(boxes)):
            if not bmask[i]:
                continue
            n = int(valid[i].sum())
            c = cls[i, :n].astype(np.float64)
            c = np.where(decisions[i, :n] == 0, float(UNKNOWN_CLASS_INDEX), c)
            all_preds.append(dict(img_name=batch["im_names"][i],
                                  bboxes=boxes[i, :n].astype(np.float64), cls=c,
                                  conf=confs[i, :n].astype(np.float64)))
            tgt_m = batch["gt_mask"][i]
            tcls = batch["gt_labels"][i][tgt_m].astype(np.float64)
            tcls = np.where(np.isin(tcls, known_arr), tcls, float(UNKNOWN_CLASS_INDEX))
            all_targets.append(dict(img_name=batch["im_names"][i],
                                    bboxes=batch["gt_bboxes"][i][tgt_m].astype(np.float64),
                                    cls=tcls))
    return compute_metrics(all_preds, all_targets, list(class_names),
                           list(known_classes), logger)
