"""OoD method factory (port of ood_in_object_detection_tpu/cli/factory.py;
reference select_ood_detection_method, ood_evaluation.py:179-289)."""

from __future__ import annotations

from ..ood.methods import (DISTANCE_METHODS, DistanceOODMethod, FusionOODMethod,
                           LOGITS_METHODS, SDR_METHODS, LogitsOODMethod)
from ..ood.sdr import attach_sdr_transform


# scales reachable per family through the CLI (models/yolo.py SCALES/SPECS).
# v9 l/x remap to c, mirroring the reference's fallthrough for sizes its v9
# repo doesn't ship (custom_training.py:90-127).
FAMILY_SCALES = {
    "yolov8": "nsmlx",
    "yolov9": "tsmce" + "lx",  # l/x remapped to c below
    "yolov10": "nsmblx",
    "yolo11": "nsmlx",
    "yolo12": "nsmlx",
}


def resolve_model_name(model_version: str, scale: str) -> str:
    """The build_model name of a (family, scale) pair; a bad pair exits here
    with the valid scales named."""
    valid = FAMILY_SCALES.get(model_version)
    if valid is None:
        raise SystemExit(f"unknown model_version '{model_version}'; have {sorted(FAMILY_SCALES)}")
    if scale not in valid:
        raise SystemExit(
            f"{model_version} has no '{scale}' scale; valid scales: "
            f"{', '.join(valid.replace('lx', '') if model_version == 'yolov9' else valid)}"
            + (" (l/x map to c)" if model_version == "yolov9" else ""))
    if model_version == "yolov9" and scale in ("l", "x"):
        return "yolov9c"  # v9 has t/s/m/c/e variants only (models/yolo.py)
    return f"{model_version}{scale}"


def build_ood_method(name: str, cluster_method: str = "one",
                     cluster_optimization_metric: str = "silhouette",
                     fusion_strategy: str = "none", temperature_energy: float = 1.0,
                     temperature_odin: float = 1000.0, use_values_before_sigmoid: bool = True,
                     device=None):
    """A logits, distance or fusion method from its CLI name, recursively for
    'fusion-M1-M2[-M3]' (each distance member takes the next of the
    '-'-separated cluster methods). An SDR method (Umap in ``umap`` mode,
    CosineIvis, L1Ivis and L2Ivis in ``ivis`` mode) gets its embedding
    transform, fitted on ``device`` (None: the card) at its first
    ``generate_clusters``."""
    if name.startswith("fusion-"):
        parts = name.split("-")[1:]
        if len(parts) not in (2, 3):
            raise ValueError(f"fusion needs 2 or 3 members: {name}")
        cluster_methods = cluster_method.split("-")
        members = []
        ci = 0
        for p in parts:
            m = build_ood_method(p, cluster_methods[min(ci, len(cluster_methods) - 1)],
                                 cluster_optimization_metric, "none", temperature_energy,
                                 temperature_odin, use_values_before_sigmoid, device)
            ci += isinstance(m, DistanceOODMethod)
            members.append(m)
        strategy = fusion_strategy if fusion_strategy != "none" else "and"
        if len(parts) == 3 and strategy != "vote":
            strategy = "vote" if fusion_strategy == "none" else fusion_strategy
        return FusionOODMethod(members, strategy=strategy, name=name)
    if name in LOGITS_METHODS:
        temper = {"Energy": temperature_energy, "ODIN": temperature_odin}.get(name, 1.0)
        return LogitsOODMethod(name, temper=temper,
                               use_values_before_sigmoid=use_values_before_sigmoid)
    if name in DISTANCE_METHODS:
        m = DistanceOODMethod.from_name(
            name, cluster_method=cluster_method,
            cluster_optimization_metric=cluster_optimization_metric)
        if name in SDR_METHODS:
            attach_sdr_transform(m, kind="umap" if name == "Umap" else "ivis", device=device)
        return m
    raise ValueError(f"unknown OoD method {name}")
