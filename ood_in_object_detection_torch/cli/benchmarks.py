"""Benchmark sweeps of the OoD evaluation CLI (``--benchmark``).

Port of ood_in_object_detection_tpu/cli/benchmarks.py:24-118 (reference
ood_evaluation.py:847-1342). Each sweep iterates one knob over its grid in
``constants.BENCHMARKS`` and re-runs only the stages the knob invalidates,
writing one CSV/XLSX row per grid point:

- ``conf_thr_test``: one InD fit, an evaluation per point (reference :1031);
- ``fusion_strategies``: one InD fit per fusion method of the grid, an
  evaluation per strategy (and, or, score) on it (reference :1217);
- ``used_tpr``: the InD activations extracted once and reloaded from the
  disk cache for every later point, thresholds refit per point;
- ``conf_thr_train``, ``which_split_for_ind_scores``, ``cluster_methods``,
  ``logits_methods``, ``best_methods``: a full InD fit per point
  (``cluster_methods`` fits the distance method with each clusterer of the
  grid; ``best_methods`` fits every logits and distance method, the SDR
  ones included);
- ``unk_loc_enhancement``: one InD fit, then an EUL evaluation per
  combination of CUSTOM_HYP.unk values (:1283-1342), under
  CUSTOM_HYP.BENCHMARK_MODE (the post-NMS prediction cache, so the forward
  runs once per batch) restored afterwards.

Methods a sweep builds fit their SDR embedders on the detector's device.
"""

from __future__ import annotations

import itertools
from copy import deepcopy
from typing import Dict, List

from .. import constants as C
from ..core.config import CUSTOM_HYP, set_by_dotted_path
from ..eval.results_writer import append_results
from .factory import build_ood_method


def check_sweep(name: str) -> None:
    """Raise for an unknown sweep, before any work."""
    if name not in C.AVAILABLE_BENCHMARKS:
        raise ValueError(f"unknown benchmark {name}")


def run_benchmark(args, detector, method, ind_batches, logger, val_batches=None,
                  mesh=None) -> List[Dict]:
    """Run sweep ``args.benchmark`` and write its rows to
    ``RESULTS_PATH/<name>_<args.name>``; -> the rows."""
    from .ood_eval import build_val_batches, configure_ind, run_eval

    name = args.benchmark
    check_sweep(name)
    rows: List[Dict] = []

    def full_run(local_args, local_method):
        nonlocal val_batches
        if local_args.which_split in ("val", "train_val") and val_batches is None:
            val_batches = build_val_batches(args)  # the sweep may visit val splits
        configure_ind(local_args, detector, local_method, ind_batches, logger,
                      val_batches=val_batches, mesh=mesh)
        rows.extend(run_eval(local_args, detector, local_method, logger, mesh))

    if name in ("best_methods", "logits_methods"):
        for m_name in C.BENCHMARKS[name]:
            logger.info("benchmark %s: method=%s", name, m_name)
            m = build_ood_method(m_name, args.cluster_method, args.cluster_optimization_metric,
                                 args.fusion_strategy, args.temperature_energy,
                                 args.temperature_odin, device=detector.device)
            a = deepcopy(args)
            a.ood_method = m_name
            full_run(a, m)
    elif name == "used_tpr":
        acts_done = False
        for tpr in C.BENCHMARKS["used_tpr"]:
            a = deepcopy(args)
            a.tpr_thr = tpr
            a.load_ind_activations = acts_done or args.load_ind_activations
            full_run(a, method)
            acts_done = True
    elif name in ("conf_thr_train", "which_split_for_ind_scores", "cluster_methods"):
        for v in C.BENCHMARKS[name]:
            a = deepcopy(args)
            m = method
            if name == "conf_thr_train":
                a.conf_thr_train = v
            elif name == "which_split_for_ind_scores":
                a.which_split = v
            else:
                logger.info("benchmark %s: cluster_method=%s", name, v)
                a.cluster_method = v
                m = build_ood_method(args.ood_method, v, args.cluster_optimization_metric,
                                     args.fusion_strategy, args.temperature_energy,
                                     args.temperature_odin, device=detector.device)
            full_run(a, m)
    elif name == "conf_thr_test":
        configure_ind(args, detector, method, ind_batches, logger, val_batches=val_batches,
                      mesh=mesh)
        for v in C.BENCHMARKS["conf_thr_test"]:
            a = deepcopy(args)
            a.conf_thr_test = v
            rows.extend(run_eval(a, detector, method, logger, mesh))
    elif name == "fusion_strategies":
        fusion_names, strategies = C.BENCHMARKS["fusion_strategies"]
        for f_name in fusion_names:
            logger.info("benchmark %s: method=%s", name, f_name)
            m = build_ood_method(f_name, args.cluster_method, args.cluster_optimization_metric,
                                 "and", args.temperature_energy, args.temperature_odin,
                                 device=detector.device)
            a0 = deepcopy(args)
            a0.ood_method = f_name
            configure_ind(a0, detector, m, ind_batches, logger, val_batches=val_batches, mesh=mesh)
            for strat in strategies:
                m.strategy = strat
                a = deepcopy(a0)
                a.fusion_strategy = strat
                rows.extend(run_eval(a, detector, m, logger, mesh))
    elif name == "unk_loc_enhancement":
        grid_spec = C.BENCHMARKS["unk_loc_enhancement"][0]
        keys = list(grid_spec)
        prior_mode = CUSTOM_HYP.BENCHMARK_MODE
        CUSTOM_HYP.BENCHMARK_MODE = True
        try:
            configure_ind(args, detector, method, ind_batches, logger, val_batches=val_batches,
                      mesh=mesh)
            for combo in itertools.product(*grid_spec.values()):
                for k, v in zip(keys, combo):
                    set_by_dotted_path(CUSTOM_HYP, k, v)
                CUSTOM_HYP.unk.USE_UNK_ENHANCEMENT = True
                a = deepcopy(args)
                a.enhanced_unk_localization = True
                rows.extend(run_eval(a, detector, method, logger, mesh))
        finally:
            CUSTOM_HYP.BENCHMARK_MODE = prior_mode

    out = append_results(rows, C.RESULTS_PATH, f"{name}_{args.name}")
    logger.info("benchmark results written to %s", out)
    return rows
