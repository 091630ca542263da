"""Re-homed from ood_in_object_detection_tpu/core/config.py unchanged, so
that the port's main path imports nothing of the JAX package. Field names
and defaults stay the JAX package's (tests/test_torch_scores.py pins them).

Typed hyperparameter/config tree with dotted-path overrides.

Replaces the reference's three-tier flag system — Tap argparsers
(ood_evaluation.py:33-176), ultralytics default.yaml overrides, and the
mutable ``CUSTOM_HYP`` dataclass singleton (custom_hyperparams.py:117-152) —
with one tree. Field names mirror custom_hyperparams.py so benchmark sweep
specs (dotted-path setattr, ood_evaluation.py:1432-1472) port unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class IvisParams:
    # SDR embedder params (reference custom_hyperparams.py:22-27; the TPU
    # rebuild's ood/sdr.py JAX siamese embedder consumes the same knobs)
    EMBEDDING_DIMS: int = 32
    N_EPOCHS_WITHOUT_PROGRESS: int = 20
    K: int = 15
    MODEL: str = "maaten"


@dataclass
class DimensionalityReductionParams:
    ivis: IvisParams = field(default_factory=IvisParams)


@dataclass
class FusionParams:
    CLIP_FUSION_SCORES: bool = True
    LOGITS_USE_PIECEWISE_FUNCTION: bool = True
    DISTANCE_USE_FROM_ZERO_TO_THR: bool = False
    DISTANCE_USE_IN_DISTRIBUTION_TO_DEFINE_LIMITS: bool = True
    # The reference's per-stride distance compute_indness
    # (ood_utils.py:1598-1617) tests isinstance(thresholds[cls], float) on
    # the per-CLASS list (never float), so under its shipped defaults it
    # returns -1 for EVERY box. Our default implements the piecewise math
    # that branch clearly intends; set True to replicate the reference's
    # literal executable behavior (cross-executed in
    # tests/test_reference_pipeline_parity.py).
    DISTANCE_INDNESS_REFERENCE_QUIRK: bool = False


@dataclass
class ClustersParams:
    MIN_SAMPLES: int = 3
    RANGE_OF_CLUSTERS: List[int] = field(default_factory=lambda: list(range(2, 15)))
    VISUALIZE: bool = False
    USE_DENSITY_BASED_METRIC: bool = False
    MAKE_EACH_ORPHAN_EACH_OWN_CLUSTER: bool = False
    REMOVE_ORPHANS: bool = False
    MAX_PERCENT_OF_ORPHANS: float = 0.95


@dataclass
class RankParams:
    RANK_BOXES_OPERATION: str = "entropy"
    MAX_NUM_UNK_BOXES_PER_IMAGE: int = 3
    GET_BOXES_WITH_GREATER_RANK: bool = False
    NMS: float = 0.5
    USE_OOD_THR_TO_REMOVE_PROPS: bool = False
    USE_UNK_PROPOSALS_THR: bool = False


@dataclass
class UnkEnhancementParams:
    USE_UNK_ENHANCEMENT: bool = False
    USE_HEURISTICS: bool = True
    SUMMARIZATION_METHOD: str = "mean_absolute_deviation_of_ftmaps"
    THRESHOLDING_METHOD: str = "recursive_otsu"
    NUM_THRESHOLDS: int = 3
    OTSU_RECURSIVE_TRICK_FOR_4_THRS: bool = False
    USE_SIMPLE_HEURISTICS: bool = False
    USE_FIRST_THRESHOLD: bool = True
    MIN_BOX_SIZE: int = 1
    MAX_BOX_SIZE_PERCENT: float = 0.95
    MAX_IOU_WITH_PREDS: float = 0.0
    MAX_INTERSECTION_W_PREDS: float = 0.0
    RANK_BOXES: bool = True
    rank: RankParams = field(default_factory=RankParams)


@dataclass
class Hyperparams:
    IOU_THRESHOLD: float = 0.5
    GOOD_NUM_SAMPLES: int = 25
    MIN_NUMBER_OF_SAMPLES_FOR_THR: int = 5
    clusters: ClustersParams = field(default_factory=ClustersParams)
    dr: DimensionalityReductionParams = field(default_factory=DimensionalityReductionParams)
    fusion: FusionParams = field(default_factory=FusionParams)
    unk: UnkEnhancementParams = field(default_factory=UnkEnhancementParams)
    USE_ONLY_SUBSET_OF_IMAGES: bool = False
    IMAGES_TO_SELECT: List[str] = field(default_factory=list)
    BENCHMARK_MODE: bool = False


def set_by_dotted_path(cfg: Any, path: str, value: Any) -> None:
    """``set_by_dotted_path(hyp, 'unk.rank.NMS', 0.25)`` — mirrors the
    benchmark sweep mutation (reference ood_evaluation.py:1432-1472)."""
    parts = path.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    if not hasattr(obj, parts[-1]):
        raise AttributeError(f"no config field {path!r}")
    setattr(obj, parts[-1], value)


def hyperparams_to_dict(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten to {'unk.rank.NMS': 0.5, ...} for results-row serialization
    (reference custom_hyperparams.py:5-20)."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(hyperparams_to_dict(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


# Module-level default instance, mirroring `CUSTOM_HYP` (custom_hyperparams.py:152).
CUSTOM_HYP = Hyperparams()
