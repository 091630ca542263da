"""OoD evaluation CLI of the PyTorch port, with the flag names of
``ood_in_object_detection_tpu/cli/ood_eval.py`` (the reference's
ood_evaluation.py Tap parser, :33-176).

Flow (reference main(), ood_evaluation.py:662-846): build the detector and
the InD/OoD datasets -> method factory -> InD configuration (activations ->
clusters -> scores -> thresholds, cached under storage/) -> evaluate each
OoD dataset -> CSV/XLSX rows. Datasets, constants, results writing and the
hyperparameters are the port's own copies of the JAX package's NumPy modules
(data/, constants.py, eval/results_writer.py, core/config.py). ``--bf16``
runs the model with f32 parameters and bf16 compute and taps, as the JAX
CLI's flag does. ``--benchmark`` runs one of the sweeps of
``cli/benchmarks.py``. ``--export_bundle DIR`` writes a serving bundle
(``utils/export.py``) after the InD configuration. ``--data_parallel``
predicts each batch over a mesh (parallel/mesh.py; the JAX CLI's
ood_eval.py:338-346): every visible card, ``--device``'s first, or the
entries of a comma list (``--device 0,1``; ``cpu,cpu`` on the CPU); the
batch must divide over it. Flags whose features are not ported yet raise
NotImplementedError naming their ROADMAP.md item.

    python -m ood_in_object_detection_torch.cli.ood_eval --ood_method MSP \\
        --ind_dataset ind.yaml --ood_datasets ood.yaml --device 0 [--data_parallel]
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .. import constants as C
from ..core.checkpoint import load_checkpoint
from ..core.config import CUSTOM_HYP, hyperparams_to_dict
from ..data import DetectionDataset, PaddedBatcher
from ..engine import Detector
from ..eval.results_writer import (
    append_results, fill_dataset_results, finalize_row, method_info_row,
)
from ..core.precision import disable_tf32
from ..ood.clustering import check_cluster_method
from ..ood.methods import DistanceOODMethod, FusionOODMethod
from ..ood.pipeline import (_leaf_methods, assign_fitted_state, collect_fusion_member_indness,
                            evaluate_method, extract_ind_activations)
from .benchmarks import check_sweep, run_benchmark
from .factory import build_ood_method, resolve_model_name

log = logging.getLogger("ood_eval")

# flag -> the ROADMAP.md item that will port it
UNPORTED_FLAGS = {
    "compile_cache": "none: the eager port compiles nothing ahead of time",
}

# per-task known-class counts (reference select_number_of_classes_owod)
OWOD_TASK_NC = {"t1": 20, "t2": 40, "t3": 60, "t4": 80, "all_task_test": 80}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ood_eval", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ood_method", required=True, help="method name or fusion-M1-M2[-M3]")
    p.add_argument("--model", default="l", choices=["n", "s", "m", "b", "l", "x", "t", "c", "e"])
    p.add_argument("--model_version", default="yolov8",
                   choices=["yolov8", "yolov9", "yolov10", "yolo11", "yolo12"])
    p.add_argument("--model_path", default="",
                   help="checkpoint dir (core/checkpoint.py): its meta.json names the model")
    p.add_argument("--device", default="0",
                   help="CUDA device index, or 'cpu' for the plain PyTorch versions; with "
                        "--data_parallel a comma list names the mesh's entries (0,1 or cpu,cpu)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--name", default="prueba")
    p.add_argument("--logdir", default="logs")
    p.add_argument("--ind_dataset", required=True, help="dataset yaml path")
    p.add_argument("--ood_datasets", nargs="+", required=True, help="dataset yaml paths")
    p.add_argument("--ind_split", default="train", choices=["train", "val", "test"])
    p.add_argument("--ood_split", default="val", choices=["train", "val", "test"])
    tasks = ["", "t1", "t2", "t3", "t4", "all_task_test"]
    p.add_argument("--owod_task_ind", default="", choices=tasks)
    p.add_argument("--owod_task_ood", default="", choices=tasks)
    p.add_argument("--owod_tasks_dir", default=str(
        Path(__file__).resolve().parents[2] / "datasets_utils" / "owod" / "tasks"))
    p.add_argument("--conf_thr_train", type=float, default=0.15)
    p.add_argument("--conf_thr_test", type=float, default=0.15)
    p.add_argument("--tpr_thr", type=float, default=0.95)
    p.add_argument("--which_split", default="train", choices=["train", "val", "train_val"])
    p.add_argument("--cluster_method", default="one")
    p.add_argument("--cluster_optimization_metric", default="silhouette",
                   choices=list(C.AVAILABLE_CLUSTER_OPTIMIZATION_METRICS))
    p.add_argument("--ind_info_creation_option", default="valid_preds_one_stride",
                   choices=C.IND_INFO_CREATION_OPTIONS)
    p.add_argument("--which_internal_activations", default="roi_aligned_ftmaps",
                   choices=C.INTERNAL_ACTIVATIONS_EXTRACTION_OPTIONS)
    p.add_argument("--remove_orphans", action="store_true")
    p.add_argument("--visualize_clusters", action="store_true")
    p.add_argument("--use_values_before_sigmoid", action="store_true", default=True)
    p.add_argument("--no_use_values_before_sigmoid", dest="use_values_before_sigmoid",
                   action="store_false")
    p.add_argument("--fusion_strategy", default="none", choices=["and", "or", "score", "none"])
    p.add_argument("--dump_fusion_scores", default="",
                   help="write each fusion member's per-box INDness on the first OoD "
                        "dataset to this .npz")
    p.add_argument("--enhanced_unk_localization", action="store_true",
                   help="add enhanced unknown localization (EUL) proposals as unknowns")
    p.add_argument("--visualize_oods", action="store_true")
    p.add_argument("--temperature_energy", type=float, default=1.0)
    p.add_argument("--temperature_odin", type=float, default=1000.0)
    p.add_argument("--benchmark", default="", choices=[""] + C.AVAILABLE_BENCHMARKS,
                   help="run one sweep of constants.BENCHMARKS instead of one evaluation")
    p.add_argument("--load_ind_activations", action="store_true")
    p.add_argument("--load_clusters", action="store_true")
    p.add_argument("--load_thresholds", action="store_true")
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--bf16", action="store_true",
                   help="run the model in bfloat16: f32 parameters, bf16 compute and taps")
    p.add_argument("--compute_metrics", action="store_true", default=True)
    p.add_argument("--data_parallel", action="store_true",
                   help="predict each batch data parallel over a mesh: every visible card "
                        "(--device's first) or --device's comma list; --batch_size must "
                        "divide over it")
    p.add_argument("--export_bundle", default="",
                   help="after the InD configuration, write a serving bundle of the detector "
                        "and the fitted method to this directory (utils/export.py)")
    p.add_argument("--export_bundle_batch", type=int, default=1,
                   help="the batch size the bundle's predict step is exported at")
    p.add_argument("--compile_cache", default="", help="not ported")
    return p


def check_ported(args) -> None:
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md: {item})")
    for c in args.cluster_method.split("-"):
        check_cluster_method(c)
    if args.benchmark:
        check_sweep(args.benchmark)


def torch_device(spec: str) -> torch.device:
    """'cpu' or a CUDA index (the first entry of a comma list); a CUDA
    device that is missing raises. A card becomes the current one, where
    the kernels launch. Switches TF32 off (core/precision.py), for the CPU
    too: the CLIs' f32 path is f32."""
    disable_tf32()
    spec = str(spec).split(",")[0].strip()
    if spec == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec}: CUDA is not available (pass --device cpu "
                           "to run the plain PyTorch versions on the CPU)")
    dev = torch.device(f"cuda:{int(spec)}")
    torch.cuda.set_device(dev)
    return dev


def data_parallel_mesh(args):
    """The mesh of ``--data_parallel`` (None without it): ``--device``'s
    comma list, or one entry and every other visible card after it (the
    CPU alone under ``--device cpu``). The first entry is the detector's
    device, where the outputs gather. ``--batch_size`` must divide over the
    mesh (ValueError; the JAX CLI asserts it). Several entries without
    ``--data_parallel`` raise ValueError."""
    from ..parallel.mesh import make_multislice_mesh, parse_devices, visible_cards

    entries = parse_devices(args.device)
    if not args.data_parallel:
        if len(entries) > 1:
            raise ValueError(f"--device {args.device}: several entries need --data_parallel")
        return None
    if len(entries) == 1 and entries[0].type == "cuda":
        entries += [d for d in visible_cards() if d != entries[0]]
    mesh = make_multislice_mesh(model=1, devices=entries)
    n = len(mesh.batch_devices)
    if args.batch_size % n:
        raise ValueError(f"--batch_size {args.batch_size} must divide over the mesh's {n} "
                         "devices")
    log.info("data-parallel over %s", mesh)
    return mesh


def cache_paths(args, method) -> Dict[str, Path]:
    """Cache keys of the reference (ood_evaluation.py:291-336), under a
    'torch_' prefix so the two packages never read each other's files; a
    checkpoint's directory stem stands for the model, as in the JAX CLI."""
    ckpt_name = (Path(args.model_path).stem if getattr(args, "model_path", "")
                 else f"{args.model_version}{args.model}")
    internal = "logits" if not method.is_distance_method else "roi_aligned_ftmaps"
    base = f"torch_{internal}_conf{args.conf_thr_train}_{ckpt_name}"
    if method.is_distance_method:
        base += f"_{args.ind_info_creation_option}"
    C.STORAGE_PATH.mkdir(parents=True, exist_ok=True)
    return {
        "activations": C.STORAGE_PATH / f"{base}_activations.pkl",
        "clusters": C.STORAGE_PATH / f"{base}_{getattr(method, 'cluster_method', 'None')}_clusters.pkl",
        "thresholds": C.STORAGE_PATH / f"{base}_tpr{args.tpr_thr}_thresholds.pkl",
    }


def load_detector(args, default_nc: int = 20) -> Detector:
    """The detector of ``--model_path`` (its meta.json's model, the class
    count from meta's ``nc``, then ``train_args.nc``, then the task's), or
    else a seeded random one of ``--model_version``/``--model``."""
    nc = OWOD_TASK_NC.get(args.owod_task_ind, 0) or default_nc
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
    device = torch_device(args.device)
    if getattr(args, "model_path", ""):
        sd, meta = load_checkpoint(args.model_path)
        ckpt_nc = meta.get("nc") or meta.get("train_args", {}).get("nc") or nc
        return Detector.create(meta["model_name"], nc=ckpt_nc, img_size=args.img_size,
                               device=device, dtype=dtype, state_dict=sd)
    name = resolve_model_name(args.model_version, args.model)
    return Detector.create(name, nc=nc, img_size=args.img_size, device=device, dtype=dtype)


def load_dataset(args, path_or_name: str, split: str, owod_task: str) -> DetectionDataset:
    return DetectionDataset.from_yaml(path_or_name, split=split, owod_task=owod_task or None,
                                      tasks_dir=args.owod_tasks_dir or None)


def _batches(args, ds) -> list:
    return list(PaddedBatcher(ds, args.batch_size, args.img_size))


def build_val_batches(args) -> list:
    """Val-split InD batches for the which_split threshold-score selection
    (reference dataloader_val, ood_evaluation.py:714-720)."""
    return _batches(args, load_dataset(args, args.ind_dataset, "val", args.owod_task_ind))


def _load_or_extract(args, detector, method, batches, cache_file, logger, mesh=None):
    if args.load_ind_activations and cache_file.exists():
        logger.info("loaded InD activations from %s", cache_file)
        return pickle.loads(cache_file.read_bytes())
    t0 = time.perf_counter()
    acts = extract_ind_activations(detector, batches, method, args.conf_thr_train, mesh=mesh)
    logger.info("extracted InD activations in %.1fs", time.perf_counter() - t0)
    cache_file.write_bytes(pickle.dumps(acts))
    return acts


def _concat_acts(a, b):
    """Per-leaf concat of train + val activations (reference
    concat_arrays_inside_list_of_lists, ood_evaluation.py:599-640)."""
    def cat(x, y):
        if isinstance(x, list):
            return [cat(xi, yi) for xi, yi in zip(x, y)]
        if y.shape[0] == 0:
            return x
        if x.shape[0] == 0:
            return y
        return np.concatenate([x, y], axis=0)

    return {k: cat(a[k], b[k]) for k in a}


def configure_ind(args, detector, method, batches, logger, val_batches=None,
                  mesh=None) -> None:
    """InD pipeline with disk caching (reference
    execute_pipeline_for_in_distribution_configuration, ood_evaluation.py:398):
    clusters always come from the train activations; the threshold scores
    from the split that --which_split names."""
    paths = cache_paths(args, method)
    leaves = _leaf_methods(method)

    def by_leaf(acts):  # re-key by position (pickles lose object ids)
        return {id(m): v for m, v in zip(leaves, acts.values())}

    acts = by_leaf(_load_or_extract(args, detector, method, batches,
                                    paths["activations"], logger, mesh))
    if args.which_split == "train":
        score_acts = acts
    else:
        if val_batches is None:
            raise ValueError(f"which_split={args.which_split} needs val batches")
        val_file = paths["activations"].with_name(
            paths["activations"].name.replace(".pkl", "_val.pkl"))
        acts_val = by_leaf(_load_or_extract(args, detector, method, val_batches,
                                            val_file, logger, mesh))
        score_acts = acts_val if args.which_split == "val" else _concat_acts(acts, acts_val)

    clusters_loaded = False
    if args.load_clusters and paths["clusters"].exists():
        assign_fitted_state(method, clusters=pickle.loads(paths["clusters"].read_bytes()))
        clusters_loaded = True
        logger.info("loaded clusters from %s", paths["clusters"])
    for m in leaves:
        if isinstance(m, DistanceOODMethod) and not (clusters_loaded and m.clusters):
            m.generate_clusters(acts[id(m)])
        m.generate_thresholds(m.compute_scores_from_activations(score_acts[id(m)]),
                              args.tpr_thr)
    if args.load_thresholds and paths["thresholds"].exists():
        assign_fitted_state(method, thresholds=pickle.loads(paths["thresholds"].read_bytes()))
        logger.info("loaded thresholds from %s", paths["thresholds"])
    paths["clusters"].write_bytes(pickle.dumps([getattr(m, "clusters", None) for m in leaves]))
    paths["thresholds"].write_bytes(pickle.dumps([m.thresholds for m in leaves]))
    paths["thresholds"].with_suffix(".json").write_text(json.dumps({
        k: getattr(args, k) for k in (
            "ood_method", "cluster_method", "cluster_optimization_metric",
            "fusion_strategy", "temperature_energy", "temperature_odin",
            "use_values_before_sigmoid", "which_internal_activations",
            "ind_info_creation_option", "tpr_thr", "conf_thr_train")}))


def _dataset_key(yaml_name: str) -> str:
    for key in ("coco_ood", "coco_mixed", "owod"):
        if key in yaml_name:
            return key
    return "coco_ood"


def run_eval(args, detector, method, logger, mesh=None) -> List[Dict]:
    row = method_info_row(method, args.which_split, args.conf_thr_train,
                          args.conf_thr_test, args.tpr_thr, args.fusion_strategy)
    for ds_path in args.ood_datasets:
        ds = load_dataset(args, ds_path, args.ood_split, args.owod_task_ood)
        known = list(range(ds.number_of_classes))
        names = ds.names[: ds.number_of_classes] + ["unknown"]
        vis_dir = (str(C.RESULTS_PATH / "visualizations" / f"{args.name}_{ds.yaml_name}")
                   if args.visualize_oods else None)
        batches = PaddedBatcher(ds, args.batch_size, args.img_size)
        batches.tag = ds.yaml_name  # names the dataset in the BENCHMARK_MODE cache's key
        metrics = evaluate_method(detector, batches, method, known, names,
                                  conf_thr_test=args.conf_thr_test,
                                  enhanced_unk_localization=args.enhanced_unk_localization,
                                  logger=logger, visualize_dir=vis_dir, mesh=mesh)
        logger.info("%s -> %s", ds.yaml_name, metrics)
        fill_dataset_results(row, _dataset_key(ds.yaml_name), metrics, args.owod_task_ood)
    row = finalize_row(row, f"{args.model_version}{args.model}", vars(args))
    row["custom_hyp"] = str(hyperparams_to_dict(CUSTOM_HYP))  # the port's tree, not the JAX one
    return [row]


def dump_fusion_scores(args, detector, method, logger, mesh=None) -> None:
    """Each fusion member's per-box INDness, the fused decision, classes and
    confidences on the first OoD dataset -> ``np.savez`` at
    --dump_fusion_scores (the JAX CLI's ood_eval.py:380-394)."""
    if not isinstance(method, FusionOODMethod):
        raise ValueError("--dump_fusion_scores needs a fusion-... method")
    ds = load_dataset(args, args.ood_datasets[0], args.ood_split, args.owod_task_ood)
    data = collect_fusion_member_indness(detector, _batches(args, ds), method,
                                         conf_thr_test=args.conf_thr_test, mesh=mesh)
    Path(args.dump_fusion_scores).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.dump_fusion_scores, **data)
    logger.info("fusion member scores -> %s", args.dump_fusion_scores)


def main(argv=None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    check_ported(args)
    logging.basicConfig(level=logging.INFO)
    mesh = data_parallel_mesh(args)
    if args.remove_orphans:
        CUSTOM_HYP.clusters.REMOVE_ORPHANS = True
    if args.visualize_clusters:
        CUSTOM_HYP.clusters.VISUALIZE = True
    ind = load_dataset(args, args.ind_dataset, args.ind_split, args.owod_task_ind)
    detector = load_detector(args, default_nc=ind.number_of_classes)
    method = build_ood_method(
        args.ood_method, args.cluster_method, args.cluster_optimization_metric,
        args.fusion_strategy, args.temperature_energy, args.temperature_odin,
        use_values_before_sigmoid=args.use_values_before_sigmoid, device=detector.device)
    for m in _leaf_methods(method):
        if isinstance(m, DistanceOODMethod):
            m.ind_info_creation_option = args.ind_info_creation_option
            if args.which_internal_activations in C.FTMAPS_RELATED_OPTIONS:
                m.which_internal_activations = args.which_internal_activations
    val_batches = build_val_batches(args) if args.which_split in ("val", "train_val") else None
    ind_batches = _batches(args, ind)
    if args.benchmark:
        return run_benchmark(args, detector, method, ind_batches, log, val_batches=val_batches,
                             mesh=mesh)
    configure_ind(args, detector, method, ind_batches, log, val_batches=val_batches, mesh=mesh)
    if args.export_bundle:
        from ..utils.export import export_serving_bundle

        export_serving_bundle(detector, method, args.export_bundle,
                              batch=args.export_bundle_batch, conf_thres=args.conf_thr_test)
        log.info("serving bundle written to %s", args.export_bundle)
    if args.dump_fusion_scores:
        dump_fusion_scores(args, detector, method, log, mesh)
    rows = run_eval(args, detector, method, log, mesh)
    out = append_results(rows, C.RESULTS_PATH, args.name)
    log.info("results written to %s", out)
    return rows


if __name__ == "__main__":
    main()
