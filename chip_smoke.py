#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --reference-seeds 4   # the readings of REF_LIMITS (and the rest)
    python3 chip_smoke.py --only e2e_train      # the training phase alone
    python3 chip_smoke.py --only e2e_dp         # the data-parallel phase alone
    python3 chip_smoke.py --only e2e_clusters   # MeanShift, GMM, BGMM through the CLI
    python3 chip_smoke.py --only e2e_sp         # the spatial-parallel phase alone
    python3 chip_smoke.py --only e2e_sp_train   # sp and model axes in training alone

Phases, each printing one JSON line (a failure anywhere raises, and the
script exits non-zero without printing a result):

1. env: torch / CUDA versions, the card's name and power limit (the raw
   ``nvidia-smi --query-gpu=name,power.limit`` line is printed on its own),
   TF32 switched off for matmuls and cuDNN convolutions.
2. build: compile the seven CUDA kernels from ``csrc/`` with nvcc, one
   process per source, all at once.
3. e2e (the f32 path): yolov8l at 640 px, nc=20, seeded random weights
   (BatchNorm statistics calibrated on the run's images, the head's output
   convs spread from a numpy seed), batches of 8 seeded uint8 images. Ground
   truth comes from the model's own first predict pass. Extract -> fit ->
   evaluate for MSP and Cosine_cl_stride; the kernels' launch counters are
   reset just before and read just after, and K1, K2 (f32), K3 and K4 must
   have launched.
4. e2e_eul (enhanced unknown localization on the f32 path): e2e's detector
   and fitted Cosine_cl_stride, evaluate with EUL over the OoD batches at
   the default CUSTOM_HYP.unk (mean-absolute-deviation saliency, recursive
   Otsu with 3 thresholds, entropy rank, top 3 an image, rank NMS 0.5),
   the counters reset just before and read just after: K1-K4 must have
   launched and the rank's own K2 and K3 launches (those beyond the same
   evaluation without EUL) must show. Candidates must exist and the OWOD
   dict must be finite. The front end on the card against the same P3
   through the CPU (each threshold within one histogram bin, at most
   0.5 % of mask cells differing), the rank's K2 and K3 against their
   plain versions and the whole rank against the CPU's; proposals per
   image, eval seconds with and without EUL, the front end's device time,
   the host time of connected components and selection, the rank's K2 and
   K3 times.
5. e2e_sweeps (the --benchmark sweeps on the f32 path): e2e's detector,
   8 seeded InD batches of 8 scenes (discs on a background, with noise;
   ``make_scenes``) labelled like e2e's (min / median / max samples per
   (class, stride) group printed) and one OoD batch written to a
   temporary directory as a dataset, driven through
   ``cli.benchmarks.run_benchmark`` with results and caches there. The
   cluster_methods sweep fits Cosine_cl_stride with every clusterer of
   the grid (host seconds of each fit, groups fitted, centroids, largest
   K, mean and spread of the counts, K3's launches and the OWOD columns per
   method): K1-K4 must have launched, K3 on a bank of K > 1 for every
   method but 'one', every OWOD value finite. The unk_loc_enhancement sweep
   (9 combinations, BENCHMARK_MODE's cache) must run the detector's forward
   (K4's counter) once per OoD batch over all combinations. K3 is then
   held against its plain version at the fitted 'all' and 'KMeans' banks
   on the OoD batch's features (``cluster_banks`` in the kernels line).
5b. e2e_clusters (the clusterers outside the sweep grid, on the f32 path):
   e2e's detector and e2e_sweeps' scenes (per method the first
   CLUSTERS_IND_BATCHES InD batches, printed: MeanShift on all 8, the
   mixtures on 1, whose host EM took ~5 minutes on all 8 and ~2.5 on 2)
   written as datasets; ``cli.ood_eval --cluster_method``
   MeanShift, then GMM, then BGMM for Cosine_cl_stride, each after
   ``np.random.seed(SEED)``, MeanShift with ``--visualize_clusters``, the
   counters reset just before the three runs and read just after (K1-K4
   must launch, K3 in each run). Per method the fit's host seconds, the
   grid searches, the groups fitted and those with K > 1, the bank's
   largest K and valid centroids, K3's launches, the OWOD row and the OoD
   batch's share of boxes called OoD; every method must fit some group
   with K > 1, so that K3 meets a bank of several centroids per group;
   the score-curve PNGs must number the grid searches. K3
   against its plain version at each of the three banks (``cluster_banks``
   in the kernels line). ``python3 chip_smoke.py --only e2e_clusters``
   runs it alone.
6. e2e_sdr (the SDR methods on the f32 path): e2e's detector and
   e2e_sweeps' batches; one InD extraction, then for each of Umap,
   CosineIvis, L1Ivis and L2Ivis a fit (the per-stride triplet embedders on
   the card, 32 wide, then clusters and thresholds in the embedded space)
   and an evaluation, with the counters read around each: fit seconds split
   into the host's triplet sampling and an estimate of device time (each
   stride's Adam step profiled), steps and widths per stride, eval
   seconds, the OoD share, K3's launches (one per OoD batch for cosine and
   l2, none for L1Ivis, which takes the plain l1 path) and K3 at D 32
   against its plain version (device time, bound, cuBLAS + amin). The
   card's distances against the CPU's on the same embedders and taps
   within SDR_DIST_REL_LIMITS, decisions equal away from the threshold;
   the card's fit held by quality (sdr_fit_quality): trustworthiness, for
   the ivis methods class separation above PCA's, and the final loss
   against a CPU fit's from the same init on the same triplets.
   Then cli.benchmarks.run_benchmark's fusion_strategies (9 rows) and
   best_methods (12 rows) on the first SDR_SWEEP_IND_BATCHES InD batches,
   cli.extract_activations with --model_path (e2e's
   weights as a checkpoint; its per-group counts equal the phase's own
   extraction) and embedding_plot._fit_transform in modes sdr and pca_sdr
   on its payload (the plot itself needs matplotlib, which the card's
   machine lacks). K3's D 32 entry in the kernels line carries its
   launches.
7. e2e_serve (the serving path on the f32 path): e2e's detector saved as
   a checkpoint (core/checkpoint.py) and loaded onto the card, bit-equal;
   cli.ood_eval --model_path for MSP and Cosine_cl_stride on e2e's batches
   written as datasets (the caches must carry the checkpoint's stem);
   cli.predict --model_path on 16 PNGs with the fitted Cosine_cl_stride
   verdicts, its predictions.json equal to predict + decisions of the same
   letterboxed batches, and the same CLI in a fresh process (which starts
   with PyTorch's defaults, cuDNN TF32 on) bit-equal to it, while e2e's
   detector with TF32 switched on in this process differs (the control of
   core/precision.py's contract); a MicroBatchServer (batch 8, 2 ms wait, the fitted
   method attached) under 8 closed-loop client threads, 64 requests, then a
   lone request that pads a partial group: every result equal to a direct
   predict of its group, served images/s, p50 and p99 latency, launches per
   group; one full served group against the CPU's plain versions within
   REF_LIMITS. The counters are reset just before and read just after the
   predict CLI and the server, and K1-K4 must have launched in each.
8. e2e_bf16 (the --bf16 path): the same weights and batches in a bf16
   detector (f32 parameters, bf16 compute and taps), extract -> fit ->
   evaluate again with the counters reset; K4 and K2's bf16 route must have
   launched. Prints the bf16 predict step and the share of detections and of
   per-box decisions that differ from the f32 path, each under a ceiling.
9. e2e_bundle (the serving bundle, utils/export.py): e2e_serve's
   checkpoint through ``cli.ood_eval --model_path ... --ood_method
   fusion-MSP-Cosine_cl_stride --export_bundle DIR --export_bundle_batch 8``,
   in f32 and with --bf16 (export seconds, bundle bytes); each bundle
   served by ``scripts/serve_bundle.py`` in a fresh process given only DIR
   and an .npy of 64 images, under 8 closed-loop clients: load and warm-up
   seconds, images/s, p50 / p99 latency, K4, K1 and K2 (K2b in bf16)
   launches per group and K3's, all counted in that process with its
   counters reset just before the clients. Every result against the live
   detector (e2e's, e2e_bf16's) and the bundle's method on the same stacked
   batch: counts, classes and verdicts equal, floats bit for bit. Then a
   bundle exported from the CPU detector of the same weights, served on the
   card (K4, K1, K2 must launch), against the f32 bundle served on the CPU,
   image by image within REF_LIMITS.
9b. e2e_dp (data parallelism, parallel/): e2e's detector through
   ``Detector.predict_sharded`` on a mesh of every visible card and on
   [cuda:0, cuda:0] (shards of 4), the counters reset just before and read
   just after each: valid, classes, anchors and levels equal to
   ``Detector.predict`` of the batch, floats within DP_PREDICT_LIMITS (the
   spread printed), K4, K1 and K2 launched on every replica's card (counts
   per card index), ms against predict's. ``cli.ood_eval --data_parallel``
   (``--device 0,0`` on one card, so two shards gather on it; every card
   otherwise) on e2e_serve's checkpoint and datasets: MSP and
   Cosine_cl_stride rows equal to the runs without the flag. The batch-16 train step (yolov8l,
   seeded, tests/test_train.py's noise batch) on a process group of
   ``device_count()`` ranks (NCCL) where more than one card exists (with
   one, a world of one rank would run the single-device step; the two gloo
   ranks of card 0 named twice run in e2e_sp_train's first spawn, world
   ``data2``, against this phase's reference), spawned by
   parallel/distributed.py: the
   first step's loss and update against the single-process step on the
   same global batch within DP_TRAIN_LIMITS, every rank's state equal
   (digest), then ms a step, each rank's peak memory and the gradient
   all-reduce's seconds and megabytes; a rank that fails fails the phase.
   ``python3 chip_smoke.py --only e2e_dp`` runs it alone.
9c. e2e_sp (spatial parallelism, parallel/spatial.py): e2e's detector
   through ``Detector.predict_sharded`` on meshes whose ``sp`` axis splits
   the image height, the card named as often as the mesh has entries:
   ``sp`` 2 and 4 at batch 1 and ``data`` 2 x ``sp`` 2 at batch 8, each
   against ``Detector.predict`` of the same images with the counters reset
   just before and read just after (f32: each layer within SP_LAYER_REL of
   the unsharded layer on the same input, and the outputs within the
   model's SP_F32_LIMITS; where the neck maps are bit-equal, integer
   outputs equal and DP_PREDICT_LIMITS; K4 launched once a slab, K1 and K2
   once a batch shard); e2e_bf16's detector at ``sp`` 2, batch 8, within
   SP_BF16_LIMITS (bit-equal); two halo faults planted at ``sp`` 2 (one
   layer's window off by a row, max-pools without their halo rows) that
   the layer check must catch (``--only e2e_sp --reference-seeds 2``
   takes the readings of all these limits, sp_spread); K4 on the
   second shard's halo slab against its plain version and its kept rows
   against the unsharded K4's (STEM_TOL), the slab's times; a
   MicroBatchServer over ``sp`` 2 serving 16 requests, each equal to its
   group's direct predict_sharded row; yolov9c, yolov10l, yolo11l and
   yolo12l at ``sp`` 2, batch 1. Printed: sharded and predict ms (CUDA
   events), halo rows and bytes a step, the threads' barrier wait (host
   ms); one mesh over every card where more than one is visible, else a
   line that it was not run. ``python3 chip_smoke.py --only e2e_sp`` runs
   it alone (with bench_k3's profile_coverage at its start and end).
9d. e2e_sp_train (spatial and tensor parallelism in training,
   parallel/{mesh,distributed,spatial}.py, train/trainer.py): the batch-16
   step of yolov8l at 640 px (nc 20, TF32 off, seeded, e2e_dp's noise
   batch) on gloo worlds of card 0 named 2 or 4 times, one rank an entry
   (SP_TRAIN_SPAWNS: e2e_dp's ``data`` 2, then ``sp`` 2, then ``model`` 2
   on one spawned pair of ranks, ``data`` 2 x ``sp`` 2 on four; each rank
   makes the batch),
   each rank's part placed by device_put_batch (its rows, on ``sp`` its
   slab of the height) and the state by shard_state (on ``model`` each
   rank's slice of the split convs). The first step on rank 0, on the state
   gather_state gathers, against e2e_dp's single-process step on the same
   global batch within DP_TRAIN_LIMITS (loss terms, the update of every
   trained tensor), a second gather's digest equal, the ranks of each
   ``model`` index equal (digests); at ``sp`` 2 a step with remat from the
   saved start (the recompute on the card's autograd thread runs under the
   rank's shard), within the same limits; planted faults, each a step from
   the saved start in the same world, at least TRAIN_FAULT_FACTOR x over
   their limit (train_fault: ``no_halo_grad``, ``loss_gather_summed``
   at ``sp`` 2, ``no_tp_input_reduce`` at ``model`` 2). One line a world:
   step ms and images/s (CUDA events), halo and gather MB, exchanges and
   wait seconds a step each way per rank, the gradient all-reduce's MB and
   seconds, peak memory per rank, backend, the card's name and power limit.
   No kernel launches in training. ``python3 chip_smoke.py --only
   e2e_sp_train`` runs it alone (taking its own single-process step).
10. reference: one image through the card (kernels) and through the CPU
   (plain PyTorch versions) with the same weights; maps, detections and
   taps must agree within REF_LIMITS, and each layer (the stem also
   through fused_stem, K4 on the card) within LAYER_REL_TOL on the CPU's
   own input to it.
11. profile, profile_bf16: device time of the predict step by kernel
   (torch.profiler).
12. kernels: each kernel against its plain PyTorch version on the card, on
   tensors captured from the main paths (plus controlled, chain, k = 4096,
   (2, 8400) and k = 16384 NMS cases, K 5 and K 200 centroid banks with
   masked centroids and empty groups, yolov8n's stem widths and a corner
   impulse for the stem), with times from CUDA events, the least time the
   card could take (bound_ms) and one PyTorch call computing the same
   function where there is one (library_ms). K1 also gets each case's
   device time per phase, mask and sweep (torch.profiler, phase_ms) and
   valid candidates per image; K2 and K3 their device time beside the
   wrapper's (device_ms: CUDA events around calls queued behind a spinning
   kernel, as torch.profiler drops records); K3 each case's times and cuBLAS's x @ C.T plus
   the masked minimum (cublas_amin_ms); K2 gets Q built from wx and wy plus
   torch.bmm (library_with_q_ms) and, per level, the count of non-empty
   rows and the median, p99 and largest support rectangle; K4 gets the
   launcher alone on operands folded once (kernel_ms). K1, K2, K2b and K4
   also get the ``ood_torch`` operator's time against its CUDA
   implementation called directly on the same inputs (operator_ms,
   direct_ms, dispatch_us; ops/library.py). K2 (f32) and K3 also
   carry ``eul_rank``: their numbers at the EUL rank's inputs, and K3
   ``cluster_banks``: its numbers at the fitted banks of e2e_sweeps and
   e2e_clusters; K4 ``sp_slab``: its numbers on e2e_sp's halo slab. Every
   ``device_ms`` of the phase must be above 0 (the instrument missed a
   kernel that launched; K3's is taken by CUDA events around calls queued
   behind a spinning kernel, as torch.profiler drops device records late
   in the script: bench_k3.profile_coverage, printed). Launch counts add up
   every main path's run (e2e, e2e_eul, e2e_sweeps, e2e_clusters,
   e2e_serve, e2e_bf16, e2e_bundle with its serving processes, e2e_dp,
   e2e_sp); e2e_sdr's entry carries its own;
   e2e_families' entries carry their own model's counts, e2e_train's those
   of its last validation.
13. e2e_families (the other YOLO families on the f32 path): yolov9c,
   yolov10l, yolo11l and yolo12l (the l models of the paper's V9-V12
   results) at 640 px, nc=20, batch 8, TF32 off, seeded, BatchNorm
   calibrated and head spread as in e2e, 2 InD batches and one OoD batch
   of their own. Per model, with the counters reset just before and read
   just after extract -> fit -> evaluate (MSP, Cosine_cl_stride), K1-K4
   must have launched; one line with the parameter count, stem route, eval
   seconds, predict step (CUDA events, mean of 10), device time by kernel
   (torch.profiler; K3 from one batch's decisions; PyTorch's depthwise
   convolutions; for yolov10l also the device time of the one2many
   branches, which its predict step does not run) and launches a step;
   ``reference_family``: one image on the card against the CPU, as
   ``reference`` holds yolov8l, within that model's REF_LIMITS; K1-K4
   against their plain versions on the model's own tensors, as kernel
   entries tagged with the model. yolo12l runs again
   in bf16 (attention, K2b and K4's bf16 route at full width).
14. e2e_xscale (K4's second specialization, C1 96 / C2 192): yolo11x
   seeded, BatchNorm calibrated and head spread, one predict step in f32
   and in bf16 with the counters reset just before and read just after (K4
   once each), then K4 against its plain version on that stem, kernel
   entries tagged ``model: yolo11x``.
15. e2e_train (training and its validation): TRAIN_IMAGES + VAL_IMAGES
   seeded scenes labelled by e2e's detector as a dataset with train and val
   splits, and e2e's weights saved as a training state at epoch -1 (a
   start that ``--resume`` takes at epoch 0). cli.train at yolov8l, 640 px,
   nc 20, TF32 off, batch 16, mosaic, HSV and flip, 2 epochs, validation
   every epoch with the counters reset just before and read just after
   each ``validate`` (K4, K1 and K2 must launch; mAP50 and mAP50-95
   finite): images/s per epoch (host clock), validation seconds. cli.val on
   the last checkpoint: its --out equal to validate's numbers. Resume: a
   run from the epoch-0 checkpoint continues at epoch 1, its first step's
   loss that of the uninterrupted run (letterboxed batches in order).
   K1 and K2 on validation's own tensors (conf 0.001), entries tagged
   ``case: val_conf0.001`` (K1 with valid candidates per image). A train
   step at batch 16 in f32, f32 with remat and bf16: CUDA-event ms, peak
   memory, f32's device time by op (torch.profiler). 25 steps on one fixed
   batch of 8 in f32 and bf16 (tests/test_train.py's overfit check: the
   last loss below OVERFIT_RATIO x the first, the EMA moved). One f32 step
   at batch 2 on the card against the CPU from the same weights within
   TRAIN_REF_LIMITS (``--reference-seeds`` takes their readings,
   train_spread). yolov10l: the one2one loss alone leaves the backbone and
   neck with zero gradient on the card; 2 dual-loss steps at batch 8, finite.
   ``python3 chip_smoke.py --only e2e_train`` runs this phase alone.
16. stem_parts (the stem probe ladder's path): the ladder entry point
   (``python -m ood_in_object_detection_torch.scripts.bench_stem_parts``)
   driven through all four ladders at full size, z (128, 160(+2), 160, 48)
   bf16, with the counters reset just before and read just after; the
   window copy, shift-add and GEMM kernels must have launched. Then every
   rung's kernel against its plain version on the same inputs: copies and
   shifts bit-exact, GEMM modes within 2^-7 of the output's largest
   magnitude; three more entries in the kernels line. The GEMM rungs also
   carry the rung timed as library calls, torch ops + cuBLAS + F.silu
   (library_composite_ms).

The last lines are the ``{"kernels": [...]}`` object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

SEED = 0
MODEL = "yolov8l"  # the paper's flagship model
BATCH = 8
IMG = 640
NC = 20
DEVICE = "cuda"
CONF = 0.15  # the CLI's conf_thr_train / conf_thr_test defaults
OWOD_KEYS = {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}
# bf16 against f32 on random weights: the maps of a random yolov8n differ by
# 29-52 % of their largest magnitude between the two precisions
# (tests/bf16_margin_search.py --bn-scale 1.0),
# so detections near the confidence threshold or an NMS tie, and boxes near
# a fitted threshold, change sides. Ceilings on the share that differs:
DET_FLIP_CEIL, DECISION_FLIP_CEIL = 0.5, 0.5
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def unfused_stem_ms(det, images) -> float:
    """The predict step with the stem's two Conv modules (cuDNN) in place of
    K4, for comparison."""
    det.model.folded_stem = False
    try:
        return cuda_ms(lambda: det.predict(images, conf_thres=CONF), reps=10)
    finally:
        det.model.folded_stem = True


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dispatch_ms(op_call, direct_call, reps: int = 50, rounds: int = 3) -> dict:
    """An ``ood_torch`` operator's call against the direct call of its CUDA
    implementation (ops/library.py) on the same inputs, alternated
    ``rounds`` times, ``reps`` calls each (CUDA events): the least of each
    and the difference, the dispatcher's cost, in microseconds."""
    op, direct = [], []
    for _ in range(rounds):
        op.append(cuda_ms(op_call, reps=reps))
        direct.append(cuda_ms(direct_call, reps=reps))
    return dict(operator_ms=min(op), direct_ms=min(direct),
                dispatch_us=(min(op) - min(direct)) * 1e3)


def bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def counters():
    """(wrapper, attribute) of every kernel's launch counter."""
    from ood_in_object_detection_torch.ood import distance as D
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops import roi_align as R
    from ood_in_object_detection_torch.ops import stem as S
    from ood_in_object_detection_torch.ops import stem_parts as SP

    return {"greedy_keep": (N.greedy_keep, "launches"),
            "roi_contract": (R.roi_contract, "launches"),
            "roi_contract_bf16": (R.roi_contract, "launches_bf16"),
            "min_group_distances": (D.min_group_distances, "launches"),
            "fused_stem": (S.fused_stem, "launches"),
            "window_copy": (SP.window_copy, "launches"),
            "shift_add": (SP.shift_add, "launches"),
            "stem_gemm": (SP.stem_gemm, "launches")}


def reset_counters() -> None:
    import collections

    for fn, attr in counters().values():
        setattr(fn, attr, 0)
        if hasattr(fn, attr + "_by_device"):
            setattr(fn, attr + "_by_device", collections.Counter())


def read_counters() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def run_methods(det, ind, ood):
    """Extract -> fit -> evaluate MSP and Cosine_cl_stride; -> (methods,
    OWOD metric dicts), both checked."""
    from ood_in_object_detection_torch.ood.methods import DistanceOODMethod, LogitsOODMethod
    from ood_in_object_detection_torch.ood.pipeline import (evaluate_method,
                                                            extract_ind_activations,
                                                            fit_ind_pipeline)

    known, names = list(range(NC)), [f"c{k}" for k in range(NC)] + ["unknown"]
    results = {}
    methods = {"MSP": LogitsOODMethod("MSP"),
               "Cosine_cl_stride": DistanceOODMethod.from_name("Cosine_cl_stride")}
    for name, m in methods.items():
        acts = extract_ind_activations(det, ind, m, conf_thr_train=CONF)
        fit_ind_pipeline(m, acts, tpr=0.95)
        results[name] = evaluate_method(det, ood, m, known, names, conf_thr_test=CONF)
    for name, m in methods.items():
        flat = np.asarray([t for t in np.ravel(np.asarray(m.thresholds, dtype=object))
                           if t is not None], np.float64)
        if not (flat.size and np.isfinite(flat).all()):
            raise AssertionError(f"{name}: no finite fitted thresholds ({m.thresholds})")
        res = results[name]
        if set(res) != OWOD_KEYS or not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"{name}: bad OWOD metric dict {res}")
    n_clusters = sum(isinstance(c, np.ndarray) and c.ndim == 2
                     for row in methods["Cosine_cl_stride"].clusters for c in row)
    if n_clusters == 0:
        raise AssertionError("Cosine_cl_stride fitted no clusters")
    return methods, results, n_clusters


def phase_env(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = dict(python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
               device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
               nvidia_smi=smi, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    emit("env", **env)
    return env


def make_batches(rng, n_batches: int):
    return [rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8) for _ in range(n_batches)]


def label_batches(det, images, unknown_every: int = 0, max_gt: int = 20):
    """Batch dicts whose ground truth is the model's own top detections;
    with ``unknown_every`` every that-many-th box gets a class outside the
    known ones."""
    out = []
    for bi, imgs in enumerate(images):
        p = det.predict(imgs, conf_thres=CONF)
        boxes, cls, valid = (p.det.boxes.cpu().numpy(), p.det.cls.cpu().numpy(),
                             p.det.valid.cpu().numpy())
        gtb = np.zeros((BATCH, max_gt, 4), np.float32)
        gtc = np.zeros((BATCH, max_gt), np.int32)
        gtm = np.zeros((BATCH, max_gt), bool)
        for i in range(BATCH):
            n = min(int(valid[i].sum()), max_gt)
            gtb[i, :n], gtc[i, :n], gtm[i, :n] = boxes[i, :n], cls[i, :n], True
            if unknown_every:
                gtc[i, unknown_every - 1:n:unknown_every] = NC + 5
        out.append(dict(images=imgs, gt_bboxes=gtb, gt_labels=gtc, gt_mask=gtm,
                        im_names=[f"b{bi}_{i}" for i in range(BATCH)],
                        ratio_pad=[((1.0, 1.0), (0.0, 0.0))] * BATCH))
    return out


def phase_e2e(torch):
    rng = np.random.default_rng(SEED)
    ind_imgs, ood_imgs = make_batches(rng, 2), make_batches(rng, 1)
    det = family_detector(torch, MODEL, ind_imgs + ood_imgs)

    ind = label_batches(det, ind_imgs)
    ood = label_batches(det, ood_imgs, unknown_every=3)

    reset_counters()
    t0 = time.perf_counter()
    methods, results, n_clusters = run_methods(det, ind, ood)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    path = ("greedy_keep", "roi_contract", "min_group_distances", "fused_stem")
    if not all(launches[k] for k in path) or launches["roi_contract_bf16"]:
        raise AssertionError(f"the f32 path did not launch its kernels: {launches}")

    out = det.predict(ood_imgs[0], conf_thres=CONF)
    for t in (out.det.boxes, out.det.conf, out.logits, out.roi_feats, out.exact_feats):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite predict output")
    step_ms = cuda_ms(lambda: det.predict(ood_imgs[0], conf_thres=CONF), reps=10)
    x = torch.from_numpy(ood_imgs[0]).to(DEVICE).permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: det.model(x.contiguous()), reps=10)
    emit("e2e", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="float32",
         seconds=seconds, launches=launches, metrics=results, clusters=n_clusters,
         thresholds={k: m.thresholds for k, m in methods.items()},
         detections_per_image=float(out.det.valid.sum(1).float().mean()),
         predict_step_ms=step_ms, model_forward_ms=forward_ms,
         images_per_s=BATCH * 1000.0 / step_ms,
         predict_step_ms_unfused_stem=unfused_stem_ms(det, ood_imgs[0]))
    return det, methods, ind, ood, launches, step_ms


# the front end on the card against the CPU: each threshold within one
# histogram bin (1/256 of the image's saliency range; a cell whose f32
# saliency sums in another order crosses a bin edge and may move Otsu's
# argmax by a bin), and the share of mask cells that differ
EUL_THR_TOL_BINS, EUL_MASK_DIFF_CEIL = 1.0, 0.005
# letterbox pads (px, py) in stride-8 cells for the front end's comparison
EUL_PADS = [[0, 0], [0, 4], [2, 0], [3, 5]] * (BATCH // 4)


def host_s(fn, reps: int = 5) -> float:
    """Mean host seconds per call of a host-only ``fn``."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def eul_frontend_check(torch, UD, p3, kw):
    """The front end on the card against the same P3 through the CPU."""
    pads = torch.tensor(EUL_PADS, dtype=torch.long)
    gm, gt = UD.eul_frontend_masks(p3, pads.to(DEVICE), **kw)
    cm, ct = UD.eul_frontend_masks(p3.cpu(), pads, **kw)
    sal, _ = UD.eul_frontend(p3.cpu(), pads, **kw)
    crop = UD._grid_mask(pads, *p3.shape[1:3])
    span = torch.stack([s[c].max() - s[c].min() for s, c in zip(sal, crop)])
    gt = gt.cpu()
    same_pattern = bool(torch.equal(torch.isfinite(gt), torch.isfinite(ct)))
    fin = torch.isfinite(ct)
    bins = ((gt - ct).abs() / (span[:, None] / 256.0))[fin]
    return dict(thresholds=int(fin.sum()), finite_pattern_equal=same_pattern,
                thr_max_err_bins=float(bins.max()) if bins.numel() else 0.0,
                thr_differing=int((bins > 1e-3).sum()),
                mask_cells_differing_share=float((gm.cpu() != cm).float().mean()),
                tolerance=dict(thr_bins=EUL_THR_TOL_BINS, mask_share=EUL_MASK_DIFF_CEIL),
                pads=EUL_PADS)


def eul_breakdown(torch, det, dm, batch):
    """One batch's EUL in its parts, on e2e's detector: the front end (card
    vs CPU; device time), connected components and heuristics (host), the
    rank (K2 + K3 against their plain versions and against the CPU), the
    selection (host)."""
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP
    from ood_in_object_detection_torch.ood import distance as D
    from ood_in_object_detection_torch.ood import pipeline as P
    from ood_in_object_detection_torch.ood import unknown as U
    from ood_in_object_detection_torch.ood import unknown_device as UD
    from ood_in_object_detection_torch.ops import roi_align as R
    from ood_in_object_detection_torch.scripts import bench_k3 as BK3

    hyp = CUSTOM_HYP.unk
    kw = dict(summarizer=hyp.SUMMARIZATION_METHOD, method=hyp.THRESHOLDING_METHOD,
              num_thresholds=hyp.NUM_THRESHOLDS)
    out = det.predict(batch["images"], conf_thres=CONF)
    p3, rp = out.p3, batch["ratio_pad"]
    boxes, valid = out.det.boxes.cpu().numpy(), out.det.valid.cpu().numpy()
    pred = {i: boxes[i, : int(valid[i].sum())].astype(np.float64) for i in range(BATCH)}
    fe_check = eul_frontend_check(torch, UD, p3, kw)
    pads0 = torch.zeros((BATCH, 2), dtype=torch.long, device=DEVICE)
    fe = U.eul_frontend_batched(p3, rp)
    hw = tuple(p3.shape[1:3])

    def candidates():
        return {i: U.unknown_candidates_for_image(None, rp[i], pb, precomputed=fe[i],
                                                  padded_hw=hw) for i, pb in pred.items()}

    cand = candidates()
    n = max(len(c) for c in cand.values())
    if n == 0:
        raise AssertionError("EUL found no candidate on any image")
    props = np.zeros((BATCH, n, 4), np.float32)
    for i, c in cand.items():
        props[i, : len(c)] = c
    props = torch.tensor(props, device=DEVICE)
    bank, rows = P._stride0_rank_bank(dm, det.neck_channels()[0], DEVICE)
    op = hyp.rank.RANK_BOXES_OPERATION

    def rank():
        return P.rank_reduce_batched(p3, props, bank, rows, dm.metric, op, False)

    scores = rank()
    scores_cpu = P.rank_reduce_batched(p3.cpu(), props.cpu(), *P._stride0_rank_bank(
        dm, det.neck_channels()[0], "cpu"), dm.metric, op, False)
    rank_err = float((scores.cpu() - scores_cpu).abs().max())
    ranks = {i: scores.cpu().numpy()[i, : len(c)] for i, c in cand.items()}

    def select():
        return {i: U.finish_unknown_proposals(c, ranks.get(i) if len(c) else None,
                                              unk_prop_thr=dm.unk_prop_thr)
                for i, c in cand.items()}

    chosen = select()

    # K2 at the rank's inputs: 4 x 4 fixed hats on P3, spatial_scale 1.0
    wx, wy = (t.contiguous() for t in R.box_axis_weights(hw, props, 1.0, 4))
    got, ref = R.roi_contract(p3, wx, wy), R.roi_contract_plain(p3, wx, wy)
    k2_err = float((got - ref).abs().max())
    k2_rel = k2_err / float(ref.abs().max())
    cells = support_cells(torch, wx, wy)
    q = (wy[..., :, None] * wx[..., None, :]).reshape(BATCH, n, -1)
    fmap = p3.reshape(BATCH, -1, p3.shape[-1])
    k2 = dict(shape=list(p3.shape), rows=[BATCH, n], max_abs_err=k2_err, rel_err=k2_rel,
              ms=cuda_ms(lambda: R.roi_contract(p3, wx, wy)),
              device_ms=BK3.queued_ms(lambda: R.roi_contract(p3, wx, wy), 20),
              plain_ms=cuda_ms(lambda: R.roi_contract_plain(p3, wx, wy)),
              **bound(nbytes(p3, wx, wy, got), float(cells.sum()) * 2.0 * p3.shape[-1], "f32"),
              library_ms=cuda_ms(lambda: torch.bmm(q, fmap)),
              library="torch.bmm of the materialised Q (Q built beforehand)")
    if k2_rel > 1e-5:
        raise AssertionError(f"EUL rank K2: rel err {k2_rel} > 1e-5")
    # K3 at the rank's inputs: G = the classes, K 1, D = P3's channels
    tf = D.l2_normalize_rows(got.reshape(BATCH * n, -1))
    cents = D.l2_normalize_rows(bank.centroids[:, 0]).contiguous()
    kmask = (torch.arange(cents.shape[1], device=DEVICE)[None, :]
             < bank.count[:, 0, None]).contiguous()
    k3 = BK3.measure(tf.contiguous(), cents, kmask, dm.metric, reps=20)
    if "error" in k3 or not k3["agrees"]:
        raise AssertionError(f"EUL rank K3: {k3}")
    k3["library_ms"] = None
    return dict(
        frontend=fe_check,
        frontend_device_ms=BK3.device_ms(lambda: UD.eul_frontend_masks(p3, pads0, **kw), 10),
        frontend_ms=cuda_ms(lambda: U.eul_frontend_batched(p3, rp), reps=10),
        candidates_per_image=[len(cand[i]) for i in range(BATCH)],
        proposals_per_image=[len(chosen[i][0]) for i in range(BATCH)],
        cc_host_ms=host_s(candidates) * 1e3, select_host_ms=host_s(select) * 1e3,
        rank_ms=cuda_ms(rank), rank_device_ms=BK3.device_ms(rank, 20),
        rank_vs_cpu_max_abs_err=rank_err, k2=k2, k3=k3)


def phase_e2e_eul(torch, det, dm, ood):
    """EUL on the f32 path: e2e's detector and fitted Cosine_cl_stride over
    the OoD batches, with the counters reset around the EUL evaluation."""
    from ood_in_object_detection_torch.ood.pipeline import evaluate_method

    known, names = list(range(NC)), [f"c{k}" for k in range(NC)] + ["unknown"]

    def run(eul):
        t0 = time.perf_counter()
        res = evaluate_method(det, ood, dm, known, names, conf_thr_test=CONF,
                              enhanced_unk_localization=eul)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(True)  # first call: the front end's and the rank's first launches
    reset_counters()
    res_plain, plain_s = run(False)
    base = read_counters()
    reset_counters()
    res, eul_s = run(True)
    launches = read_counters()
    rank = {k: launches[k] - base[k] for k in ("roi_contract", "min_group_distances")}
    path = ("greedy_keep", "roi_contract", "min_group_distances", "fused_stem")
    if not all(launches[k] for k in path) or min(rank.values()) < len(ood):
        raise AssertionError(f"EUL did not launch its kernels: {launches}, the rank's {rank}")
    if set(res) != OWOD_KEYS or not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"EUL: bad OWOD metric dict {res}")
    parts = eul_breakdown(torch, det, dm, ood[0])
    fe = parts["frontend"]
    if not (fe["finite_pattern_equal"] and fe["thr_max_err_bins"] <= EUL_THR_TOL_BINS
            and fe["mask_cells_differing_share"] <= EUL_MASK_DIFF_CEIL):
        raise AssertionError(f"EUL front end: card and CPU disagree: {fe}")
    if parts["rank_vs_cpu_max_abs_err"] > 1e-4:
        raise AssertionError(f"EUL rank: card and CPU disagree: {parts['rank_vs_cpu_max_abs_err']}")
    if not any(parts["candidates_per_image"]) or not any(parts["proposals_per_image"]):
        raise AssertionError(f"EUL proposed nothing: {parts}")
    emit("e2e_eul", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="float32",
         batches=len(ood), conf_thr_test=CONF, hyp=dict(
             summarizer="mean_absolute_deviation_of_ftmaps", thresholding="recursive_otsu",
             num_thresholds=3, rank_op="entropy", top_k=3, rank_nms=0.5),
         seconds=eul_s, seconds_without_eul=plain_s, launches=launches,
         rank_launches=rank, rank_launches_per_batch={k: v / len(ood) for k, v in rank.items()},
         metrics=res, metrics_without_eul=res_plain,
         rank_k2_device_ms=parts["k2"]["device_ms"], rank_k3_device_ms=parts["k3"]["device_ms"],
         **{k: v for k, v in parts.items() if k not in ("k2", "k3")})
    return launches, parts


# the sweeps' InD batches (the earlier phases keep their 2): enough samples
# in the (class, stride) groups for every grid of the cluster search to work
SWEEP_BATCHES = 8
SWEEP_METHOD = "Cosine_cl_stride"


def make_scenes(rng, n_batches: int):
    """Seeded uint8 scenes: a background colour, 3-8 discs of random colour
    and size, sensor noise of a random level. Boxes on uniform noise give
    random-weight features that no Birch threshold of the grid splits into
    valid clusters (each of >= MIN_SAMPLES samples); on scenes Birch's
    search finds K > 1 in some groups, so every clusterer fits real banks."""
    yy, xx = np.mgrid[:IMG, :IMG]
    out = []
    for _ in range(n_batches):
        imgs = np.empty((BATCH, IMG, IMG, 3), np.float32)
        for img in imgs:
            img[:] = rng.uniform(0, 255, 3)
            for _ in range(rng.integers(3, 9)):
                cx, cy = rng.uniform(0, IMG, 2)
                r = rng.uniform(IMG / 30, IMG / 5)
                img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
            img += rng.normal(0, rng.uniform(2, 40), img.shape)
        out.append(np.clip(imgs, 0, 255).astype(np.uint8))
    return out


def write_dataset(root, batches):
    """Batches on disk as a YOLO dataset (PNG images, label files, a yaml
    naming the NC known classes) that the CLI's run_eval loads; -> the yaml.
    640 x 640 images letterbox to themselves, so the boxes stay put."""
    from pathlib import Path

    from PIL import Image

    root = Path(root)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    names = []
    for b in batches:
        for i, name in enumerate(b["im_names"]):
            Image.fromarray(b["images"][i]).save(root / "images" / f"{name}.png")
            m = b["gt_mask"][i]
            rows = [f"{int(c)} {(x1 + x2) / 2 / IMG:.6f} {(y1 + y2) / 2 / IMG:.6f} "
                    f"{(x2 - x1) / IMG:.6f} {(y2 - y1) / IMG:.6f}"
                    for (x1, y1, x2, y2), c in zip(b["gt_bboxes"][i][m], b["gt_labels"][i][m])]
            (root / "labels" / f"{name}.txt").write_text("\n".join(rows) + "\n")
            names.append(f"./images/{name}.png")
    (root / "split.txt").write_text("\n".join(names) + "\n")
    (root / "sweep_ood.yaml").write_text(
        "path: .\ntrain: split.txt\nval: split.txt\nnames:\n"
        + "".join(f"  {k}: c{k}\n" for k in range(NC)))
    return root / "sweep_ood.yaml"


def group_counts(acts) -> list:
    """Samples per (class, stride) group of a distance method's activations."""
    return [len(a) if isinstance(a, np.ndarray) and a.ndim == 2 else 0
            for row in acts for a in row]


def cluster_banks_entry(torch, det, methods, images, names=("all", "KMeans")) -> dict:
    """K3 at fitted banks (the sweep's 'all' and 'KMeans', e2e_clusters'
    MeanShift, GMM and BGMM), on the OoD batch's features: the wrapper's
    time, its device time, the plain version's time and error, the bound
    and cuBLAS's x @ C.T plus the masked minimum."""
    from ood_in_object_detection_torch.ood.pipeline import distance_features
    from ood_in_object_detection_torch.scripts import bench_k3 as BK3

    out = det.predict(images, conf_thres=CONF)
    banks = {}
    for name in names:
        m = methods[name]
        feats, groups, kmask = m.group_inputs(distance_features(m, out, det.neck_channels())[0])
        r = BK3.measure(feats, groups, kmask, m.metric, reps=20)
        if "error" in r or not r["agrees"]:
            raise AssertionError(f"min_group_distance at the {name} bank: {r}")
        banks[name] = dict(largest_k=int(kmask.sum(1).max()), **{
            k: r[k] for k in ("shape", "valid_centroids", "empty_groups", "max_abs_err", "ms",
                              "device_ms", "plain_ms", "bound_ms", "bound_by",
                              "cublas_amin_ms")})
        emit("kernel_case", kernel="min_group_distance", case=f"cluster_bank_{name}", **r)
    return banks


def phase_e2e_sweeps(torch, det):
    """The --benchmark sweeps through cli.benchmarks.run_benchmark on e2e's
    detector: cluster_methods over the whole grid, then unk_loc_enhancement
    under the BENCHMARK_MODE cache; results and caches in a temporary
    directory. -> (launches over both sweeps, the K3 cluster_banks numbers)."""
    import copy
    import logging
    import tempfile
    from pathlib import Path

    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import benchmarks as B
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP
    from ood_in_object_detection_torch.cli import ood_eval as E
    from ood_in_object_detection_torch.ood.methods import DistanceOODMethod
    from ood_in_object_detection_torch.ood.pipeline import extract_ind_activations

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    ind = label_batches(det, make_scenes(rng, SWEEP_BATCHES))
    ood = label_batches(det, make_scenes(rng, 1), unknown_every=3)
    acts = extract_ind_activations(det, ind, DistanceOODMethod.from_name(SWEEP_METHOD),
                                   conf_thr_train=CONF)
    counts = group_counts(next(iter(acts.values())))
    filled = sorted(c for c in counts if c)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sweeps_")
    root = Path(tmp.name)
    paths = (C.RESULTS_PATH, C.STORAGE_PATH, C.TEMPORAL_STORAGE_PATH)
    C.RESULTS_PATH, C.STORAGE_PATH = root / "results", root / "storage"
    C.TEMPORAL_STORAGE_PATH = root / "temp"
    unk = copy.deepcopy(CUSTOM_HYP.unk)  # the EUL sweep sets its knobs and leaves them
    yaml = write_dataset(root / "ood", ood)
    log = logging.getLogger("chip_smoke.sweeps")

    # per-evaluation records: the fitted method, its bank and the launches
    # of its evaluation; per fit the host seconds of generate_clusters
    evals, fits = [], []
    run_eval, generate = E.run_eval, DistanceOODMethod.generate_clusters

    def recording_eval(args, detector, method, logger, mesh=None):
        before, t0 = read_counters(), time.perf_counter()
        rows = run_eval(args, detector, method, logger, mesh)
        torch.cuda.synchronize()
        after = read_counters()
        evals.append(dict(method=method, rows=rows, seconds=time.perf_counter() - t0,
                          launches={k: after[k] - before[k] for k in after}))
        return rows

    def timed_generate(self, acts, *a, **kw):
        t0 = time.perf_counter()
        out = generate(self, acts, *a, **kw)
        fits.append(time.perf_counter() - t0)
        return out

    def sweep(name, cluster_method="one"):
        args = E.build_parser().parse_args([
            "--ood_method", SWEEP_METHOD, "--cluster_method", cluster_method,
            "--ind_dataset", str(yaml), "--ood_datasets", str(yaml), "--device", "0",
            "--model", MODEL[-1], "--img_size", str(IMG), "--batch_size", str(BATCH),
            "--conf_thr_train", str(CONF), "--conf_thr_test", str(CONF),
            "--benchmark", name, "--name", "chip_smoke"])
        method = E.build_ood_method(SWEEP_METHOD, cluster_method)
        evals.clear()
        fits.clear()
        t0 = time.perf_counter()
        rows = B.run_benchmark(args, det, method, ind, log)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    failures = []
    E.run_eval, DistanceOODMethod.generate_clusters = recording_eval, timed_generate
    try:
        reset_counters()
        rows, cm_seconds = sweep("cluster_methods")
        cm_launches = read_counters()
        per_method, fitted = [], {}
        for ev, fit_s, row in zip(evals, list(fits), rows):
            m = ev["method"]
            sizes = [len(c) for r in m.clusters for c in r if isinstance(c, np.ndarray)
                     and c.ndim == 2]
            kmax = int(m.bank(DEVICE).count.max())
            owod = {k: row[k] for k in row if k.endswith("(COOD)")}
            per_method.append(dict(
                cluster_method=m.cluster_method, fit_host_s=fit_s, eval_s=ev["seconds"],
                groups_fitted=len(sizes),
                centroids=sum(sizes), largest_k=kmax, mean_n_clus=row["mean_n_clus"],
                std_n_clus=row["std_n_clus"], k3_launches=ev["launches"]["min_group_distances"],
                eval_launches=ev["launches"], owod=owod))
            fitted[m.cluster_method] = m
            if not all(np.isfinite(v) for v in owod.values()) or len(owod) != 4:
                failures.append(f"cluster_methods {m.cluster_method}: bad OWOD {owod}")
            if not ev["launches"]["min_group_distances"] or (
                    m.cluster_method != "one" and kmax < 2):
                failures.append(f"cluster_methods {m.cluster_method}: K3 did not launch on a "
                                f"bank of K > 1: K {kmax}, {ev['launches']}")
        if [r["cluster_method"] for r in per_method] != list(C.BENCHMARKS["cluster_methods"]):
            failures.append(f"the sweep skipped methods: {per_method}")
        path = ("greedy_keep", "roi_contract", "min_group_distances", "fused_stem")
        if not all(cm_launches[k] for k in path):
            failures.append(f"the cluster_methods sweep did not launch K1-K4: {cm_launches}")

        reset_counters()
        ul_rows, ul_seconds = sweep("unk_loc_enhancement")
        ul_launches = read_counters()
        forwards = sum(ev["launches"]["fused_stem"] for ev in evals)
        if forwards != len(ood) or len(ul_rows) != 9:
            failures.append(f"unk_loc_enhancement: {forwards} forwards over {len(ood)} OoD "
                            f"batches and {len(ul_rows)} combos (the cache serves the rest)")
        for row in ul_rows:
            vals = [row[k] for k in row if k.endswith("(COOD)")]
            if len(vals) != 4 or not all(np.isfinite(v) for v in vals):
                failures.append(f"unk_loc_enhancement: bad row {row}")
        cache_entries = len(list(C.TEMPORAL_STORAGE_PATH.glob("*.pkl")))
    finally:
        E.run_eval, DistanceOODMethod.generate_clusters = run_eval, generate
        C.RESULTS_PATH, C.STORAGE_PATH, C.TEMPORAL_STORAGE_PATH = paths
        CUSTOM_HYP.unk = unk
        tmp.cleanup()
    banks = cluster_banks_entry(torch, det, fitted, ood[0]["images"])
    # each group's squared radius about its mean (unit rows: 1 - |mean|^2),
    # against Birch's smallest threshold, 0.1 (a radius)
    sq = [1.0 - float((f.mean(0) ** 2).sum()) for f in (
        fitted["one"].transform(a) for row in next(iter(acts.values())) for a in row
        if isinstance(a, np.ndarray) and a.ndim == 2 and len(a) > 3)]
    emit("e2e_sweeps", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="float32",
         ood_method=SWEEP_METHOD, ind_batches=SWEEP_BATCHES, ood_batches=len(ood),
         groups=len(counts), groups_with_samples=len(filled),
         samples_per_group=dict(min=filled[0], median=float(np.median(filled)), max=filled[-1],
                                total=sum(filled)) if filled else None,
         cluster_methods=dict(seconds=cm_seconds, launches=cm_launches, methods=per_method),
         unk_loc_enhancement=dict(
             seconds=ul_seconds, launches=ul_launches, combos=len(ul_rows),
             forwards_at_test_conf=forwards, cache_entries=cache_entries,
             rows=[{k: r[k] for k in r if k.endswith("(COOD)")} for r in ul_rows]),
         group_sq_radius=dict(min=min(sq), median=float(np.median(sq)), max=max(sq)),
         k3_cluster_banks=banks, phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_sweeps: " + "; ".join(failures))
    total = {k: cm_launches[k] + ul_launches[k] for k in cm_launches}
    return total, banks, ind, ood


# the single-host clusterers outside the sweep grid (e2e_clusters), in this
# order, each after np.random.seed(SEED) (GMM and BGMM draw their k-means
# initialisations from NumPy's global RandomState); the first with
# --visualize_clusters. Per method the first CLUSTERS_IND_BATCHES of the
# sweeps' InD batches: the mixtures' host EM costs k D^3 a step in each
# group (the Cholesky factors and their inverses), whatever the group's
# size, so the fits' seconds follow the groups fitted: GMM + BGMM 295 s on
# all 8 (19 groups), 151 s on 2 (14 groups), 109.5 s on 1 (8 groups, 5 of
# them K > 1). MeanShift fits all 8 in 0.66 s; on 1 batch every group kept
# K 1 (NVIDIA H100 80GB HBM3, 700.00 W, its host's 8 cores).
CLUSTERS_RUN = ("MeanShift", "GMM", "BGMM")
CLUSTERS_VIZ = "MeanShift"
CLUSTERS_IND_BATCHES = {"MeanShift": 8, "GMM": 1, "BGMM": 1}
# the mixtures' grid of n_components here: 2..3 in place of the CLI's
# RANGE_OF_CLUSTERS 2..14, so the EM factorises 5 components a group, not
# 104 (GMM + BGMM took 109.5-115.4 s of the script on the full grid, 39.0 s
# on 2..5; cut to make room for e2e_sp_train). The fit, the bank and K3 on
# it are checked as before.
CLUSTERS_MIXTURE_RANGE = list(range(2, 4))


def phase_e2e_clusters(torch, det, ind, ood):
    """cli.ood_eval --cluster_method MeanShift, GMM, BGMM (Cosine_cl_stride)
    on e2e_sweeps' scenes written as datasets (the detector handed to the
    CLI), results and caches in a temporary directory; the counters reset
    just before the three runs and read just after, each run's launches
    apart. Per method: the fit's host seconds, the groups fitted and those
    with more than one cluster, the bank's largest K and valid centroids,
    K3's launches, the OWOD row and the share of the OoD batch's boxes
    called OoD. The first run plots each grid search's score curve: one
    PNG per search. Then K3 against its plain version at each bank.
    -> (launches over the three runs, the K3 numbers of each bank)."""
    import tempfile
    from pathlib import Path

    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval as E
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP
    from ood_in_object_detection_torch.ood import methods as M
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_clusters_")
    root = Path(tmp.name)
    paths = (C.RESULTS_PATH, C.STORAGE_PATH)
    C.RESULTS_PATH, C.STORAGE_PATH = root / "results", root / "storage"
    ind_yamls = {n: write_dataset(root / f"ind{n}", ind[:n])
                 for n in set(CLUSTERS_IND_BATCHES.values())}
    ood_yaml = write_dataset(root / "ood", ood)
    run_eval, generate, fit_labels = E.run_eval, M.DistanceOODMethod.generate_clusters, \
        M.fit_cluster_labels
    load_detector, visualize = E.load_detector, CUSTOM_HYP.clusters.VISUALIZE
    grid = CUSTOM_HYP.clusters.RANGE_OF_CLUSTERS
    evals, fits, searches = [], [], []

    def recording_eval(args, detector, method, logger, mesh=None):
        before = read_counters()
        rows = run_eval(args, detector, method, logger, mesh)
        torch.cuda.synchronize()
        evals.append(dict(method=method, launches=_delta(before)))
        return rows

    def timed_generate(self, acts, *a, **kw):
        t0 = time.perf_counter()
        out = generate(self, acts, *a, **kw)
        fits.append(time.perf_counter() - t0)
        return out

    def counted_search(*a, **kw):
        searches.append(kw.get("tag"))
        return fit_labels(*a, **kw)

    failures, per_method, fitted = [], [], {}
    E.run_eval, M.DistanceOODMethod.generate_clusters = recording_eval, timed_generate
    M.fit_cluster_labels = counted_search
    E.load_detector = lambda args, default_nc=20: det
    try:
        reset_counters()
        t0 = time.perf_counter()
        for cm in CLUSTERS_RUN:
            for record in (evals, fits, searches):
                record.clear()
            np.random.seed(SEED)
            n_ind = CLUSTERS_IND_BATCHES[cm]
            CUSTOM_HYP.clusters.RANGE_OF_CLUSTERS = \
                CLUSTERS_MIXTURE_RANGE if cm in ("GMM", "BGMM") else grid
            (row,) = E.main(["--ood_method", SWEEP_METHOD, "--cluster_method", cm,
                             "--ind_dataset", str(ind_yamls[n_ind]),
                             "--ood_datasets", str(ood_yaml),
                             "--img_size", str(IMG), "--batch_size", str(BATCH),
                             "--conf_thr_train", str(CONF), "--conf_thr_test", str(CONF),
                             "--device", "0", "--name", "chip_smoke_clusters"]
                            + (["--visualize_clusters"] if cm == CLUSTERS_VIZ else []))
            CUSTOM_HYP.clusters.VISUALIZE = visualize
            (ev,), (fit_s,) = evals, fits
            m = ev["method"]
            sizes = [len(c) for r in m.clusters for c in r if isinstance(c, np.ndarray)
                     and c.ndim == 2]
            bank = m.bank(DEVICE)
            owod = {k: row[k] for k in row if k.endswith("(COOD)")}
            with torch.no_grad():
                calls = []
                for b in ood:
                    out = det.predict(b["images"], conf_thres=CONF)
                    dec = _decisions_for_method(m, out, det.neck_channels())
                    calls.append(dec[out.det.valid].cpu().numpy())
            calls = np.concatenate(calls)
            pngs = sorted((C.RESULTS_PATH / "cluster_viz").glob(f"*_{cm}_*_scores.png"))
            per_method.append(dict(
                cluster_method=cm, ind_batches=list(range(n_ind)), fit_host_s=fit_s,
                grid=list(CUSTOM_HYP.clusters.RANGE_OF_CLUSTERS) if cm != "MeanShift" else None,
                grid_searches=len(searches),
                groups_fitted=len(sizes), groups_with_k_gt_1=sum(k > 1 for k in sizes),
                centroids=sum(sizes), largest_k=int(bank.count.max()),
                valid_centroids=int(bank.count.sum()),
                k3_launches=ev["launches"]["min_group_distances"], eval_launches=ev["launches"],
                owod=owod, ood_boxes=len(calls), ood_share=float((calls == 0).mean()),
                score_curve_pngs=len(pngs) if cm == CLUSTERS_VIZ else None))
            fitted[cm] = m
            if len(owod) != 4 or not all(np.isfinite(v) for v in owod.values()):
                failures.append(f"{cm}: bad OWOD row {owod}")
            if not ev["launches"]["min_group_distances"] or not sizes:
                failures.append(f"{cm}: K3 did not launch on a fitted bank: {sizes}, "
                                f"{ev['launches']}")
            if not any(k > 1 for k in sizes):
                failures.append(f"{cm}: every group kept one cluster ({sizes}), so K3 met "
                                "no bank of several centroids per group")
            if cm == CLUSTERS_VIZ and (len(pngs) != len(searches) or not pngs):
                failures.append(f"{cm}: {len(pngs)} score-curve PNGs for {len(searches)} "
                                "grid searches")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        path = ("greedy_keep", "roi_contract", "min_group_distances", "fused_stem")
        if not all(launches[k] for k in path):
            failures.append(f"the three runs did not launch K1-K4: {launches}")
    finally:
        E.run_eval, M.DistanceOODMethod.generate_clusters = run_eval, generate
        M.fit_cluster_labels, E.load_detector = fit_labels, load_detector
        CUSTOM_HYP.clusters.VISUALIZE = visualize
        CUSTOM_HYP.clusters.RANGE_OF_CLUSTERS = grid
        C.RESULTS_PATH, C.STORAGE_PATH = paths
        tmp.cleanup()
    banks = cluster_banks_entry(torch, det, fitted, ood[0]["images"], names=CLUSTERS_RUN)
    emit("e2e_clusters", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="float32",
         ood_method=SWEEP_METHOD, ood_batches=len(ood),
         seed=SEED, seconds=seconds, launches=launches, methods=per_method,
         k3_cluster_banks=banks, phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_clusters: " + "; ".join(failures))
    return launches, banks


# the SDR methods (supervised dimensionality reduction, e2e_sdr): K3 runs on
# their 32-wide embeddings for cosine and l2, L1Ivis takes the plain l1 path
SDR_RUN = ("Umap", "CosineIvis", "L1Ivis", "L2Ivis")
SDR_K3 = {"Umap": "cosine", "CosineIvis": "cosine", "L2Ivis": "l2"}
# the card's SDR distances against the CPU's on the same embedders and taps:
# max |d_card - d_cpu| / max d_cpu over the boxes with a cluster, and the
# decisions of boxes farther than that from their threshold equal. Set from
# `python3 chip_smoke.py --reference-seeds 4` (sdr_spread: seeds 0-3 of
# e2e_sdr's scenes, sound and with a 1e-3 fault in the embedders' first
# layer; PERF.md §5): 4-5x above each method's worst sound reading, 3x or
# more below its least fault move
SDR_DIST_REL_LIMITS = {
    "Umap": 5e-5,        # sound <= 1.06e-5, fault >= 1.58e-4
    "CosineIvis": 5e-5,  # sound <= 9.5e-6, fault >= 1.74e-4
    "L1Ivis": 5e-6,      # sound <= 1.03e-6, fault >= 6.1e-4
    "L2Ivis": 2e-4,      # sound <= 4.7e-5 (l2 near 0 is a cancelled root), fault >= 5.9e-4
}
SDR_PROFILE_STEPS = 10
# the InD batches of the two sweeps here (of e2e_sweeps' 8): they took 31.6
# s on 8 on the H100 (PERF.md section 4), each grid point extracting every
# batch anew
SDR_SWEEP_IND_BATCHES = 4
# the card's SDR fits held by quality (sdr_fit_quality) on each stride of
# at least SDR_QUALITY_MIN_ROWS rows and two classes (the rest are read):
# trustworthiness (SDR_TRUST_K neighbours) above SDR_TRUST_MIN and, for the
# ivis methods, class separation above a 32-component PCA's (the bounds
# tests/test_sdr_quality.py puts on CPU fits; its second trustworthiness
# bound, within 0.1 of PCA's, is left out: on these features PCA keeps
# 0.996-1.000 and the CPU's own ivis fits read 0.835-0.953); and the final
# loss within SDR_FIT_LOSS_REL of a CPU fit's from the same init on the same
# triplets. The embeddings themselves cannot be held to the CPU's: the
# trajectories part within the first steps (scripts/bench_sdr_fit) and
# after 120 steps read 20-147 % apart. Set from `python3 chip_smoke.py
# --reference-seeds 4` (4 seeds, sound and with SDR_FIT_FAULTS; PERF.md §6,
# PR 12): sound, trustworthiness >= 0.837, ivis separation 1.26-2.99x
# PCA's, losses <= 0.112 apart; every fault reading fails a bound (ivis:
# separation 0.50-0.98x PCA's; Umap untrained: losses >= 2.18 apart).
SDR_TRUST_K, SDR_TRUST_MIN, SDR_FIT_LOSS_REL = 10, 0.75, 0.5
SDR_QUALITY_MIN_ROWS = 100
# the faults sdr_spread puts into the card's fit to show what the bounds
# catch: no training (lr 0: the initial network) and, for the ivis
# methods, the labels shuffled (a seeded permutation)
SDR_FIT_FAULTS = ("untrained", "shuffled_labels")


def sdr_copy(torch, m, fault: float = 0.0):
    """The same fitted SDR method with its embedders copied to the CPU; with
    ``fault``, copies on the embedders' own device whose first layer's
    weights are scaled by 1 + fault."""
    import copy
    import dataclasses

    def move(e):
        if e is None:
            return None
        e = copy.deepcopy(e)
        if not fault:
            return e.cpu()
        with torch.no_grad():
            e.layers[0].weight.mul_(1.0 + fault)
        return e

    c = dataclasses.replace(m, _banks={})
    c.sdr_state = dict(m.sdr_state, embedders=[move(e) for e in m.sdr_state["embedders"]])
    return c


def sdr_reading(torch, m, out, neck_ch, fault: float = 0.0) -> dict:
    """One batch's SDR distances through the card (K3 at D 32 for cosine and
    l2) against the CPU's plain path on the same embedders and the same taps
    (moved to the CPU): the largest difference relative to the largest CPU
    distance over the valid boxes that have a cluster, and whether the
    decisions agree on boxes farther than the method's SDR_DIST_REL_LIMITS
    of that scale from their threshold. ``fault``: the card's embedders'
    first layer scaled by 1 + fault."""
    from ood_in_object_detection_torch.engine import PredictOutput
    from ood_in_object_detection_torch.ood.distance import NO_CLUSTER_DISTANCE
    from ood_in_object_detection_torch.ood.pipeline import _to, distance_features
    from ood_in_object_detection_torch.ood.scores import table_lookup

    card = sdr_copy(torch, m, fault) if fault else m
    cpu = sdr_copy(torch, m)
    d_card = card.distances(*distance_features(card, out, neck_ch)).cpu()
    out_cpu = _to(PredictOutput(*out[:6], ()), "cpu")
    f, cls, lvl = distance_features(cpu, out_cpu, neck_ch)
    d_cpu = cpu.distances(f, cls, lvl)
    keep = out_cpu.det.valid.reshape(-1) & (d_cpu < NO_CLUSTER_DISTANCE)
    scale = float(d_cpu[keep].abs().max())
    err = float((d_card - d_cpu)[keep].abs().max()) / scale
    thr = table_lookup(cpu.packed_thresholds(), cls, lvl)
    clear = keep & ((d_cpu - thr).abs() > SDR_DIST_REL_LIMITS[m.name] * scale)
    dec_card, dec_cpu = ((d < thr) & ~torch.isnan(thr) for d in (d_card, d_cpu))
    return dict(boxes=int(keep.sum()), dist_rel_err=err,
                dist_abs_err=float((d_card - d_cpu)[keep].abs().max()), scale=scale,
                clear_boxes=int(clear.sum()),
                decisions_equal=bool(torch.equal(dec_card[clear], dec_cpu[clear])))


def trustworthiness(x: np.ndarray, z: np.ndarray, k: int) -> float:
    """scikit-learn's ``manifold.trustworthiness`` (euclidean): 1 minus the
    normalised excess rank, in ``x``, of each row's k nearest rows in
    ``z``."""
    n = len(x)

    def sqdist(a):
        a = np.asarray(a, np.float64)
        sq = (a * a).sum(1)
        d = sq[:, None] + sq[None, :] - 2.0 * a @ a.T
        np.fill_diagonal(d, np.inf)
        return d

    rank = np.empty((n, n), np.int64)
    rank[np.arange(n)[:, None], np.argsort(sqdist(x), axis=1)] = np.arange(1, n + 1)
    nn_z = np.argsort(sqdist(z), axis=1)[:, :k]
    excess = rank[np.arange(n)[:, None], nn_z] - k
    return float(1.0 - excess[excess > 0].sum() * 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def class_separation(z: np.ndarray, y: np.ndarray) -> float:
    """Mean distance between class centroids over the mean distance of a
    row to its class centroid (tests/test_sdr_quality.py)."""
    classes = np.unique(y)
    cents = np.stack([z[y == c].mean(0) for c in classes])
    intra = np.mean([np.linalg.norm(z[y == c] - cents[i], axis=1).mean()
                     for i, c in enumerate(classes)])
    d = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1)
    return float(d[np.triu_indices(len(classes), 1)].mean() / max(intra, 1e-9))


def sdr_fit_quality(torch, m, acts, fault=None, cpu_fits=None) -> dict:
    """Each stride's card-fitted embedder of the fitted SDR method ``m`` on
    its own fit rows: trustworthiness and class separation by the rows'
    labels, beside a 32-component PCA's of the normalised rows
    (cli/embedding_plot.PCA) and the same fit on the CPU (same init, same
    triplets); the final losses and the embeddings' gap; and the bounds
    the card's fit misses (``failures``) on the strides it is held on
    (``held``). ``fault``, one of SDR_FIT_FAULTS: the card's embedders are
    fitted anew with it. ``cpu_fits``: a dict that keeps the CPU's
    embedders (per stride) for the next reading of the same method."""
    from ood_in_object_detection_torch.cli.embedding_plot import PCA
    from ood_in_object_detection_torch.core.config import CUSTOM_HYP
    from ood_in_object_detection_torch.ood import sdr as SDR

    ivis_p = CUSTOM_HYP.dr.ivis
    fit = dict(out_dim=ivis_p.EMBEDDING_DIMS, k_neighbors=ivis_p.K)
    kind = m.sdr_state["kind"]
    cpu_fits = {} if cpu_fits is None else cpu_fits
    strides, failures = [], []
    for s, emb in enumerate(m.sdr_state["embedders"]):
        samples = SDR.stride_samples(acts, s, "ivis")  # the labels, for both kinds
        if emb is None or samples is None:
            strides.append(None)
            continue
        x, y = samples
        fit_y = y if kind == "ivis" else None
        if fault == "untrained":
            emb = SDR.fit_triplet_embedder(x, fit_y, **fit, lr=0.0, device=DEVICE)
        elif fault == "shuffled_labels":
            emb = SDR.fit_triplet_embedder(x, np.random.default_rng(SEED).permutation(y),
                                           **fit, device=DEVICE)
        if s not in cpu_fits:
            cpu_fits[s] = SDR.fit_triplet_embedder(x, fit_y, **fit, device="cpu")
        flat = SDR.normalized_rows(x)
        z, z_cpu = emb.transform(x), cpu_fits[s].transform(x)
        z_pca = PCA(min(ivis_p.EMBEDDING_DIMS, *flat.shape)).fit(flat).transform(flat)
        held = len(x) >= SDR_QUALITY_MIN_ROWS and len(np.unique(y)) > 1
        loss, loss_cpu = emb.fit_stats["final_loss"], cpu_fits[s].fit_stats["final_loss"]
        r = dict(n=len(x), classes=int(len(np.unique(y))), steps=emb.fit_stats["steps"],
                 held=held, final_loss=loss, final_loss_cpu=loss_cpu,
                 final_loss_rel=abs(loss - loss_cpu) / abs(loss_cpu),
                 embedding_gap_cpu=float(np.linalg.norm(z - z_cpu) / np.linalg.norm(z_cpu)),
                 cpu_fit_s=cpu_fits[s].fit_stats["seconds"])
        if len(x) > 2 * SDR_TRUST_K + 1:
            r.update(trust=trustworthiness(flat, z, SDR_TRUST_K),
                     trust_cpu=trustworthiness(flat, z_cpu, SDR_TRUST_K),
                     trust_pca=trustworthiness(flat, z_pca, SDR_TRUST_K))
        if r["classes"] > 1:
            r.update(separation=class_separation(z, y), separation_cpu=class_separation(z_cpu, y),
                     separation_pca=class_separation(z_pca, y))
        if held:
            if not r["trust"] > SDR_TRUST_MIN:
                failures.append(f"stride {s}: trustworthiness {r['trust']:.4f}")
            if kind == "ivis" and not r["separation"] > r["separation_pca"]:
                failures.append(f"stride {s}: class separation {r['separation']:.4f} (PCA "
                                f"{r['separation_pca']:.4f})")
            if not r["final_loss_rel"] <= SDR_FIT_LOSS_REL:
                failures.append(f"stride {s}: final loss {loss:.4f} (CPU {loss_cpu:.4f})")
        strides.append(r)
    return dict(fault=fault, strides=strides, failures=failures)


def sdr_fit_device_ms(torch, m, acts) -> list:
    """Per stride, the device milliseconds of one Adam step of that stride's
    embedder (torch.profiler over SDR_PROFILE_STEPS steps of a fresh copy of
    its architecture on the same rows and triplets), None for a stride
    without an embedder."""
    from ood_in_object_detection_torch.ood import sdr as SDR
    from ood_in_object_detection_torch.scripts import bench_k3 as BK3

    out = []
    for s, emb in enumerate(m.sdr_state["embedders"]):
        if emb is None:
            out.append(None)
            continue
        x, labels = SDR.stride_samples(acts, s, m.sdr_state["kind"])
        flat = SDR.normalized_rows(x)
        probe = SDR.TripletEmbedder(emb.widths).to(DEVICE)
        ms = BK3.device_ms(lambda: SDR.train_triplet_embedder(
            probe, flat, labels, max_steps=SDR_PROFILE_STEPS), 1)
        out.append(ms / SDR_PROFILE_STEPS)
    return out


def phase_e2e_sdr(torch, det, ind, ood):
    """The SDR methods on the f32 path, on e2e's detector and e2e_sweeps'
    batches (8 InD batches of seeded scenes, one OoD batch): extract once,
    then for each of Umap, CosineIvis, L1Ivis and L2Ivis fit (the per-stride
    embedders on the card, clusters, thresholds) and evaluate, with the
    counters read around each; the card's distances against the CPU's on the
    same embedders (sdr_reading); K3 at D 32 against its plain version; the
    fusion_strategies and best_methods sweeps through
    cli.benchmarks.run_benchmark; cli.extract_activations with --model_path
    (e2e's weights) and embedding_plot._fit_transform in modes sdr and
    pca_sdr on its payload. -> (the counters over the whole phase, the
    kernels line's K3 D 32 entry)."""
    import logging
    import tempfile
    from pathlib import Path

    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import benchmarks as B
    from ood_in_object_detection_torch.cli import embedding_plot as EP
    from ood_in_object_detection_torch.cli import extract_activations as XA
    from ood_in_object_detection_torch.cli import ood_eval as E
    from ood_in_object_detection_torch.core.checkpoint import save_checkpoint
    from ood_in_object_detection_torch.ood.methods import FusionOODMethod
    from ood_in_object_detection_torch.ood.pipeline import (_decisions_for_method,
                                                            distance_features, evaluate_method,
                                                            extract_ind_activations,
                                                            fit_ind_pipeline)
    from ood_in_object_detection_torch.scripts import bench_k3 as BK3

    t_phase = time.perf_counter()
    known, names = list(range(NC)), [f"c{k}" for k in range(NC)] + ["unknown"]
    neck_ch = det.neck_channels()
    methods = {n: E.build_ood_method(n, device=det.device) for n in SDR_RUN}
    failures, per_method, k3_cases = [], [], []
    # the main path's launches: the windows around the extraction, each fit
    # and evaluation, the sweeps and the activation dump (not the checks)
    path_launches = []
    reset_counters()
    t0 = time.perf_counter()
    acts = extract_ind_activations(det, ind, FusionOODMethod(list(methods.values())),
                                   conf_thr_train=CONF)
    extract_s = time.perf_counter() - t0
    path_launches.append(read_counters())
    out = det.predict(ood[0]["images"], conf_thres=CONF)
    for name, m in methods.items():
        before, t0 = read_counters(), time.perf_counter()
        fit_ind_pipeline(m, acts, tpr=0.95)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        embs = m.sdr_state["embedders"]
        t0 = time.perf_counter()
        res = evaluate_method(det, ood, m, known, names, conf_thr_test=CONF)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = _delta(before)
        path_launches.append(launches)
        dec = _decisions_for_method(m, out, neck_ch).cpu()
        valid = out.det.valid.cpu()
        stats = [e.fit_stats if e is not None else None for e in embs]
        step_ms = sdr_fit_device_ms(torch, m, acts[id(m)])
        reading = sdr_reading(torch, m, out, neck_ch)
        quality = sdr_fit_quality(torch, m, acts[id(m)])
        row = dict(method=name, metric=m.metric, kind=m.sdr_state["kind"], fit_s=fit_s,
                   fit_embedders_s=sum(st["seconds"] for st in stats if st),
                   fit_host_sampling_s=sum(st["sampling_s"] for st in stats if st),
                   fit_device_s_est=sum(st["steps"] * ms / 1e3 for st, ms in zip(stats, step_ms)
                                        if st),
                   strides=[None if st is None else dict(
                       n=st["n"], widths=st["widths"], steps=st["steps"], seconds=st["seconds"],
                       sampling_s=st["sampling_s"], device_ms_per_step=ms)
                            for st, ms in zip(stats, step_ms)],
                   eval_s=eval_s, ood_share=float(1.0 - dec[valid].float().mean()),
                   k3_launches=launches["min_group_distances"], launches=launches,
                   owod=res, card_vs_cpu=reading, fit_quality=quality)
        if name in SDR_K3:
            feats, groups, kmask = m.group_inputs(distance_features(m, out, neck_ch)[0])
            r = BK3.measure(feats, groups, kmask, m.metric, reps=20)
            if "error" in r or not r["agrees"]:
                failures.append(f"{name}: K3 at D 32 disagrees with its plain version: {r}")
            emit("kernel_case", kernel="min_group_distance", case=f"sdr_d32_{name}", **r)
            k3_cases.append(dict(case=f"sdr_d32_{name}", **r))
            row["k3_d32"] = {k: r.get(k) for k in ("shape", "ms", "device_ms", "plain_ms",
                                                     "bound_ms", "cublas_amin_ms",
                                                     "max_abs_err")}
        per_method.append(row)
        if not all(embs[s] is not None for s in range(3)) or \
                any(e.out_dim != 32 for e in embs if e is not None):
            failures.append(f"{name}: not every stride got a 32-wide embedder: {stats}")
        if set(res) != OWOD_KEYS or not all(np.isfinite(v) for v in res.values()):
            failures.append(f"{name}: bad OWOD metric dict {res}")
        if (launches["min_group_distances"] >= len(ood)) != (name in SDR_K3):
            failures.append(f"{name}: K3 launches {launches['min_group_distances']} in its "
                            f"evaluation of {len(ood)} batches")
        if reading["dist_rel_err"] > SDR_DIST_REL_LIMITS[name] or not reading["decisions_equal"]:
            failures.append(f"{name}: card and CPU distances disagree: {reading}")
        if quality["failures"] or not any(st and st["held"] for st in quality["strides"]):
            failures.append(f"{name}: the card's fit misses the quality bounds: {quality}")
    fit_launches = _added(*path_launches)

    # the two sweeps whose grids hold the SDR methods, and the offline tools
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sdr_")
    root = Path(tmp.name)
    paths = (C.RESULTS_PATH, C.STORAGE_PATH, C.TEMPORAL_STORAGE_PATH)
    C.RESULTS_PATH, C.STORAGE_PATH = root / "results", root / "storage"
    C.TEMPORAL_STORAGE_PATH = root / "temp"
    log = logging.getLogger("chip_smoke.sdr")
    sweeps, tools = {}, {}
    try:
        yaml = write_dataset(root / "ood", ood)
        for sweep, n_rows in (("fusion_strategies", 9), ("best_methods", 12)):
            args = E.build_parser().parse_args([
                "--ood_method", "MSP", "--ind_dataset", str(yaml), "--ood_datasets", str(yaml),
                "--device", "0", "--model", MODEL[-1], "--img_size", str(IMG),
                "--batch_size", str(BATCH), "--conf_thr_train", str(CONF),
                "--conf_thr_test", str(CONF), "--benchmark", sweep, "--name", "chip_smoke"])
            before, t0 = read_counters(), time.perf_counter()
            rows = B.run_benchmark(args, det, E.build_ood_method("MSP", device=det.device),
                                   ind[:SDR_SWEEP_IND_BATCHES], log)
            torch.cuda.synchronize()
            sweeps[sweep] = dict(seconds=time.perf_counter() - t0, rows=len(rows),
                                 methods=sorted({r["Method"] for r in rows}),
                                 launches=_delta(before))
            path_launches.append(sweeps[sweep]["launches"])
            bad = [r["Method"] for r in rows if not all(
                np.isfinite(r[k]) for k in r if k.endswith("(COOD)"))]
            if len(rows) != n_rows or bad:
                failures.append(f"{sweep}: {len(rows)} rows (want {n_rows}), not finite: {bad}")
        ckpt = root / "ckpt" / "chip_smoke_sdr"
        save_checkpoint(ckpt, det.model, {"name": ckpt.name, "nc": NC}, MODEL)
        ind_yaml = write_dataset(root / "ind", ind)
        before, t0 = read_counters(), time.perf_counter()
        payload = XA.main(["--dataset", str(ind_yaml), "--model_path", str(ckpt),
                           "--device", "0", "--img_size", str(IMG), "--batch_size", str(BATCH),
                           "--conf_thr", str(CONF), "--out", str(root / "acts.pkl")])
        torch.cuda.synchronize()
        counts = group_counts(payload["roi_feats"])
        want = group_counts(acts[id(methods["CosineIvis"])])
        tools["extract_activations"] = dict(seconds=time.perf_counter() - t0,
                                            samples=sum(counts), launches=_delta(before))
        path_launches.append(tools["extract_activations"]["launches"])
        if counts != want or len(payload["logits"]) != NC:
            failures.append(f"extract_activations: per-group samples {counts}, the phase's "
                            f"extraction {want}")
        x, y = EP._gather(payload["roi_feats"], [0, 1, 2], 500, np.random.default_rng(0))
        known = y < NC // 2
        for mode in ("sdr", "pca_sdr"):
            t0 = time.perf_counter()
            ek, eu = EP._fit_transform(mode, x[known], y[known], x[~known], epochs=20,
                                       k_neighbors=15, device=DEVICE)
            tools[f"embedding_{mode}"] = dict(seconds=time.perf_counter() - t0,
                                              known=list(ek.shape), unknown=list(eu.shape))
            if ek.shape != (int(known.sum()), 2) or eu.shape != (int((~known).sum()), 2) or \
                    not (np.isfinite(ek).all() and np.isfinite(eu).all()):
                failures.append(f"embedding_plot {mode}: {ek.shape} {eu.shape}")
    finally:
        C.RESULTS_PATH, C.STORAGE_PATH, C.TEMPORAL_STORAGE_PATH = paths
        tmp.cleanup()
    launches = _added(*path_launches)
    emit("e2e_sdr", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="float32",
         ind_batches=len(ind), ood_batches=len(ood), extract_s=extract_s,
         samples_per_stride=[sum(len(per_cls[s]) for per_cls in acts[id(methods["Umap"])]
                                 if isinstance(per_cls[s], np.ndarray)) for s in range(3)],
         methods=per_method, dist_rel_limits=SDR_DIST_REL_LIMITS, fit_quality_bounds=dict(
             trust_k=SDR_TRUST_K, trust_min=SDR_TRUST_MIN, loss_rel=SDR_FIT_LOSS_REL,
             min_rows=SDR_QUALITY_MIN_ROWS),
         fit_eval_launches=fit_launches,
         sweeps=sweeps, tools=tools, launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_sdr: " + "; ".join(failures))
    main = k3_cases[1]  # CosineIvis, the paper's SDR method
    entry = dict(name="min_group_distance", route="cuda",
                 source="ood_in_object_detection_torch/csrc/min_group_distance.cu",
                 replaces="ood_in_object_detection_tpu/ops/pallas/distance.py:59",
                 case="sdr_d32", launches=launches["min_group_distances"],
                 max_abs_err=max(c["max_abs_err"] for c in k3_cases),
                 **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                         "cublas_amin_ms")},
                 library_ms=None,
                 library="none: no single PyTorch call computes the masked minimum over each "
                         "group's centroids (cublas_amin_ms: x @ C.T, then the distance, the "
                         "mask and amin, several calls)",
                 cases=[{k: c[k] for k in ("case", "shape", "metric", "valid_centroids", "ms",
                                           "device_ms", "plain_ms", "bound_ms", "bound_by",
                                           "cublas_amin_ms", "max_abs_err")} for c in k3_cases])
    return launches, entry


# the serving path (e2e_serve): requests, client threads, the collector's wait
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_WAIT_MS = 64, 8, 2.0
PREDICT_IMAGES = 16
SERVE_KERNELS = ("greedy_keep", "roi_contract", "min_group_distances", "fused_stem")


def _delta(before: dict) -> dict:
    after = read_counters()
    return {k: after[k] - before[k] for k in after}


def _added(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _serve_check_rows(torch, det, method, batch, rows, results) -> dict:
    """The served results of one stacked batch (``rows``: request index per
    row) against a direct predict and decisions of the same batch on the
    card: counts, classes and verdicts equal, boxes, scores and logits bit
    for bit. -> the direct PredictOutput and the count of mismatches."""
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method, _np

    with torch.no_grad():
        out = det.predict(batch, conf_thres=CONF)
        dec = _np(_decisions_for_method(method, out, det.neck_channels()))
    boxes, conf, cls, valid, logits = (_np(t) for t in (out.det.boxes, out.det.conf,
                                                        out.det.cls, out.det.valid, out.logits))
    bad = 0
    for j, k in enumerate(rows):
        r, v = results[k], valid[j]
        same = (r is not None and r["num_valid"] == int(v.sum())
                and np.array_equal(r["boxes"], boxes[j][v]) and np.array_equal(r["conf"], conf[j][v])
                and np.array_equal(r["cls"], cls[j][v]) and np.array_equal(r["logits"], logits[j][v])
                and np.array_equal(r["is_ood"], dec[j][v] == 0))
        bad += not same
    return dict(out=out, mismatches=bad)


def phase_e2e_serve(torch, det, ind, ood, env, root):
    """The serving path on e2e's detector (yolov8l, f32, its seeded weights):
    a checkpoint round trip, cli.ood_eval --model_path (MSP and
    Cosine_cl_stride), cli.predict --model_path with the fitted Cosine
    verdicts on PREDICT_IMAGES PNGs (again in a fresh process, bit-equal,
    against a TF32-on control that must differ), a MicroBatchServer with that method
    under SERVE_CLIENTS closed-loop clients and a lone request, and one
    served group against the CPU's plain versions within REF_LIMITS. The
    counters are reset just before and read just after each of the three
    runs; K1-K4 must launch in the predict CLI and in the server. The
    checkpoint and the datasets stay in ``root`` for e2e_bundle. -> the
    launches of the three runs."""
    import copy
    import threading
    from pathlib import Path

    from PIL import Image

    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval as E
    from ood_in_object_detection_torch.cli import predict as P
    from ood_in_object_detection_torch.core.checkpoint import (load_checkpoint, save_checkpoint,
                                                               state_dict_equal)
    from ood_in_object_detection_torch.data.letterbox import scale_boxes_back
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method, _np
    from ood_in_object_detection_torch.serving import MicroBatchServer, _split_output

    t_phase = time.perf_counter()
    paths = (C.RESULTS_PATH, C.STORAGE_PATH)
    C.RESULTS_PATH, C.STORAGE_PATH = root / "results", root / "storage"
    failures = []
    try:
        # 1. the checkpoint, saved and loaded onto the card, bit for bit
        ckpt = root / "v8l_serve"
        t0 = time.perf_counter()
        save_checkpoint(ckpt, det.model, {"name": ckpt.name, "nc": NC}, MODEL)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd, meta = load_checkpoint(ckpt, map_location=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bit_equal = state_dict_equal(sd, det.model.state_dict())
        if not bit_equal or meta["nc"] != NC or meta["model_name"] != MODEL or \
                any(t.device.type != torch.device(DEVICE).type for t in sd.values()):
            failures.append(f"checkpoint round trip: bit_equal {bit_equal}, meta {meta}")
        checkpoint = dict(save_s=save_s, load_s=load_s, tensors=len(sd), bit_equal=bit_equal,
                          bytes=(ckpt / "state.pt").stat().st_size, meta=meta)
        del sd

        # 2. the eval CLI on the checkpoint
        ind_yaml, ood_yaml = write_dataset(root / "ind", ind), write_dataset(root / "ood", ood)
        evals, eval_launches = {}, []
        for m in ("MSP", "Cosine_cl_stride"):
            before, t0 = read_counters(), time.perf_counter()
            (row,) = E.main(["--ood_method", m, "--model_path", str(ckpt),
                             "--ind_dataset", str(ind_yaml), "--ood_datasets", str(ood_yaml),
                             "--img_size", str(IMG), "--batch_size", str(BATCH),
                             "--conf_thr_train", str(CONF), "--conf_thr_test", str(CONF),
                             "--device", "0", "--name", "chip_smoke_serve"])
            torch.cuda.synchronize()
            eval_launches.append(_delta(before))
            owod = {k: row[k] for k in row if k.endswith("(COOD)")}
            evals[m] = dict(seconds=time.perf_counter() - t0, owod=owod)
            if len(owod) != 4 or not all(np.isfinite(v) for v in owod.values()):
                failures.append(f"ood_eval --model_path {m}: bad OWOD row {owod}")
        caches = sorted(p.name for p in C.STORAGE_PATH.iterdir())
        if len(caches) != 8 or not all(f.startswith("torch_") and f"_{ckpt.name}_" in f
                                       for f in caches):
            failures.append(f"ood_eval --model_path: caches not keyed by the checkpoint: {caches}")
        (thr,) = C.STORAGE_PATH.glob("torch_roi_aligned_ftmaps_*_thresholds.pkl")
        (cl,) = C.STORAGE_PATH.glob("torch_roi_aligned_ftmaps_*_one_clusters.pkl")

        # 3. the predict CLI with the fitted verdicts, against predict +
        # decisions of the same letterboxed batches
        src = root / "predict_src"
        src.mkdir()
        pred_imgs = np.concatenate([ood[0]["images"], ind[0]["images"]])[:PREDICT_IMAGES]
        for i, im in enumerate(pred_imgs):
            Image.fromarray(im).save(src / f"p{i:02d}.png")
        argv = ["--source", str(src), "--model_path", str(ckpt), "--img_size", str(IMG),
                "--batch_size", str(BATCH), "--conf", str(CONF), "--ood_method",
                "Cosine_cl_stride", "--ood_thresholds", str(thr), "--ood_clusters", str(cl),
                "--save_json", "--no_save", "--save_dir", str(root / "pred"), "--device", "0"]
        reset_counters()
        t0 = time.perf_counter()
        recs = P.main(argv)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predict_launches = read_counters()
        if not all(predict_launches[k] for k in SERVE_KERNELS):
            failures.append(f"predict CLI did not launch K1-K4: {predict_launches}")
        if json.loads((root / "pred" / "predictions.json").read_text()) != recs:
            failures.append("predict CLI: predictions.json differs from its records")
        method = P.load_ood_method(P.build_parser().parse_args(argv))
        want, letterboxed, tf32_off = [], [], []
        files = P.collect_sources([str(src)])
        for start in range(0, len(files), BATCH):
            group = files[start:start + BATCH]
            batch, pads, origs, _ = P.letterbox_group(group, IMG, BATCH)
            with torch.no_grad():
                out = det.predict(batch, conf_thres=CONF)
                dec = _np(_decisions_for_method(method, out, det.neck_channels()))
            boxes, conf, cls, valid = (_np(t) for t in (out.det.boxes, out.det.conf,
                                                        out.det.cls, out.det.valid))
            letterboxed.append(batch)
            tf32_off.append((boxes, conf))
            for i, p in enumerate(group):
                n = int(valid[i].sum())
                b = scale_boxes_back(boxes[i, :n], pads[i], origs[i])
                want += [dict(image=str(p), bbox=b[j], category=int(cls[i, j]),
                              score=float(conf[i, j]), is_ood=bool(dec[i, j] == 0))
                         for j in range(n)]
        same = len(recs) == len(want) and all(
            (r["image"], r["category"], r["is_ood"]) == (w["image"], w["category"], w["is_ood"])
            for r, w in zip(recs, want))
        box_err = max([float(np.abs(np.asarray(r["bbox"]) - w["bbox"]).max())
                       for r, w in zip(recs, want)] + [0.0])
        score_err = max([abs(r["score"] - w["score"]) for r, w in zip(recs, want)] + [0.0])
        if not same or box_err > 1e-3 or score_err > 1e-5 or not recs:
            failures.append(f"predict CLI against predict + decisions: {len(recs)} vs "
                            f"{len(want)} records, equal {same}, box err {box_err}, score "
                            f"err {score_err}")
        predict = dict(seconds=predict_s, images=len(files), detections=len(recs),
                       ood_share=sum(r["is_ood"] for r in recs) / max(len(recs), 1),
                       launches=predict_launches, box_abs_err_px=box_err,
                       score_abs_err=score_err, images_per_s_with_io=len(files) / predict_s)

        # 3b. the precision contract (core/precision.py): the predict CLI in
        # a fresh process, which starts with PyTorch's defaults (cuDNN TF32
        # on), gives this process's records (TF32 off) bit for bit; the
        # control: this detector with TF32 switched on here differs
        fresh_dir = root / "pred_fresh"
        fresh_argv = [str(fresh_dir) if a == str(root / "pred") else a for a in argv]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, torch; print('cudnn_tf32_at_start', "
             "int(torch.backends.cudnn.allow_tf32), flush=True); from "
             "ood_in_object_detection_torch.cli.predict import main; main(sys.argv[1:])",
             *fresh_argv],
            cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
            timeout=600)
        fresh_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"predict CLI in a fresh process failed (rc "
                                 f"{proc.returncode}):\n{proc.stderr[-3000:]}")
        fresh_default_tf32 = "cudnn_tf32_at_start 1" in proc.stdout.splitlines()
        fresh = json.loads((fresh_dir / "predictions.json").read_text())
        here = json.loads((root / "pred" / "predictions.json").read_text())
        fresh_equal = fresh == here and len(here) > 0
        prior = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.no_grad():
                on = [det.predict(b, conf_thres=CONF) for b in letterboxed]
            tf32_on = [(_np(o.det.boxes), _np(o.det.conf)) for o in on]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prior
        control_equal = all(np.array_equal(a, c) for (b, conf), (bo, co) in
                            zip(tf32_off, tf32_on) for a, c in ((b, bo), (conf, co)))
        control_conf_err = max(float(np.abs(conf - co).max())
                               for (_, conf), (_, co) in zip(tf32_off, tf32_on))
        if not fresh_default_tf32 or not fresh_equal or control_equal:
            failures.append(f"precision contract: the fresh process started with cuDNN TF32 "
                            f"{fresh_default_tf32}, its records bit-equal {fresh_equal}, "
                            f"the TF32-on control equal {control_equal}")
        predict["fresh_process"] = dict(
            seconds=fresh_s, started_with_cudnn_tf32=fresh_default_tf32,
            records=len(fresh), bit_equal=fresh_equal, tf32_on_control_equal=control_equal,
            tf32_on_control_conf_abs_err=control_conf_err)

        # 4. the micro-batch server under closed-loop clients, then a lone request
        serve_imgs = np.concatenate(make_batches(np.random.default_rng(SEED + 30),
                                                 SERVE_REQUESTS // BATCH))
        views = [serve_imgs[k] for k in range(SERVE_REQUESTS)] + [serve_imgs[0].copy()]
        index = {id(v): k for k, v in enumerate(views)}
        results, lat, errors, groups = [None] * len(views), [0.0] * len(views), [], []
        srv = MicroBatchServer(det, batch_size=BATCH, max_wait_ms=SERVE_WAIT_MS, conf_thres=CONF,
                               ood_method=method)
        collect = srv._collect

        def recording_collect():  # each group's requests, in the rows' order
            group = collect()
            if group is not None:
                groups.append([index[id(r.image)] for r in group])
            return group

        srv._collect = recording_collect  # before start(): its thread's first wait
        t0 = time.perf_counter()
        srv.start()
        warmup_s = time.perf_counter() - t0

        ready = threading.Barrier(SERVE_CLIENTS)

        def client(c):
            ready.wait(timeout=60)  # the clients start together
            for k in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                t = time.perf_counter()
                try:
                    results[k] = srv.predict_one(views[k])
                except Exception as e:  # noqa: BLE001 (reported below)
                    errors.append(f"request {k}: {e!r}")
                lat[k] = time.perf_counter() - t

        try:
            reset_counters()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            serve_launches = read_counters()
            n_groups = len(groups)
            t = time.perf_counter()
            results[-1] = srv.predict_one(views[-1])
            lat[-1] = time.perf_counter() - t
            lone_launches = _delta(serve_launches)
        finally:
            srv.stop()
        if errors or any(t.is_alive() for t in threads) or any(r is None for r in results):
            failures.append(f"server: {len(errors)} failed requests {errors[:3]}")
        if not all(serve_launches[k] for k in SERVE_KERNELS):
            failures.append(f"server did not launch K1-K4: {serve_launches}")
        mismatches, first = 0, None
        for rows in groups:
            batch = np.zeros((BATCH, IMG, IMG, 3), np.uint8)
            batch[:len(rows)] = np.stack([views[k] for k in rows])
            chk = _serve_check_rows(torch, det, method, batch, rows, results)
            mismatches += chk["mismatches"]
            if first is None and len(rows) == BATCH:
                first = (batch, rows, chk["out"])
        if mismatches or groups[-1] != [SERVE_REQUESTS]:
            failures.append(f"server: {mismatches} results differ from a direct predict of their "
                            f"group; last group {groups[-1]}")
        ms = np.asarray(lat[:SERVE_REQUESTS]) * 1e3
        # a full group's device step, its decisions and the split, each alone
        batch = first[0] if first is not None else serve_imgs[:BATCH]
        with torch.no_grad():
            out = det.predict(batch, conf_thres=CONF)
            dec = _decisions_for_method(method, out, det.neck_channels())
            group_ms = dict(
                predict=cuda_ms(lambda: det.predict(batch, conf_thres=CONF), reps=10),
                decisions=cuda_ms(lambda: _decisions_for_method(method, out,
                                                                det.neck_channels()), reps=10),
                split=host_s(lambda: _split_output(out, BATCH, dec), reps=10) * 1e3)
        serve = dict(requests=SERVE_REQUESTS, clients=SERVE_CLIENTS, batch=BATCH,
                     max_wait_ms=SERVE_WAIT_MS, warmup_s=warmup_s, wall_s=wall,
                     images_per_s=SERVE_REQUESTS / wall,
                     latency_ms=dict(p50=float(np.percentile(ms, 50)),
                                     p99=float(np.percentile(ms, 99)), mean=float(ms.mean()),
                                     max=float(ms.max())),
                     groups=n_groups, group_sizes=[len(g) for g in groups[:n_groups]],
                     launches=serve_launches,
                     launches_per_group={k: serve_launches[k] / n_groups for k in SERVE_KERNELS},
                     lone_request=dict(group=len(groups[-1]), latency_ms=lat[-1] * 1e3,
                                       launches=lone_launches),
                     group_ms=group_ms,
                     group_ms_is="a full group alone: predict (CUDA events), the fitted "
                                 "method's decisions (CUDA events), _split_output with its "
                                 "copy to the host (host clock)",
                     mismatches=mismatches)

        # 5. one full served group on the card against the CPU's plain versions
        if first is None:
            raise AssertionError(f"server: no full group among {[len(g) for g in groups]}")
        batch, rows, g = first
        cpu = Detector(model=copy.deepcopy(det.model).cpu(), img_size=IMG)
        c = cpu.predict(batch, conf_thres=CONF)
        with torch.no_grad():
            x = torch.from_numpy(batch).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
            raw_g, raw_c = det.model(x.to(DEVICE))[0], cpu.model(x)[0]
        map_err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(raw_g, raw_c))
        raw_abs_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(raw_g, raw_c))
        limits, readings = REF_LIMITS[MODEL], []
        for i in range(len(rows)):
            r = detection_errors(torch, g, c, i, raw_abs_err)
            r["errors"] = dict(raw_map_rel_err=map_err, **r["errors"])
            readings.append(r)
            if not within_ref_limits(r, limits):
                failures.append(f"served group image {i}: card and CPU disagree: {r}")
        worst = {k: (min if k == "overlap" else max)(r["errors"][k] for r in readings)
                 for k in readings[0]["errors"]}
        reference = dict(images=len(rows), worst=worst, limits=limits,
                         cls_equal=all(r["cls_equal"] for r in readings),
                         detections_card=sum(r["detections_card"] for r in readings),
                         detections_cpu=sum(r["detections_cpu"] for r in readings))
    finally:
        C.RESULTS_PATH, C.STORAGE_PATH = paths
    emit("e2e_serve", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="float32",
         card=env["nvidia_smi"], checkpoint=checkpoint, ood_eval=evals, cache_files=caches,
         predict=predict, serve=serve, reference=reference,
         phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_serve: " + "; ".join(failures))
    return _added(*eval_launches, predict_launches, serve_launches, lone_launches)


BUNDLE_METHOD = "fusion-MSP-Cosine_cl_stride"  # e2e's two fitted methods, in one bundle


def phase_e2e_bundle(torch, det, det16, root, env):
    """The serving bundle on e2e's weights (yolov8l, 640 px, nc 20): for f32
    and --bf16, ``cli.ood_eval --model_path <e2e_serve's checkpoint>
    --ood_method BUNDLE_METHOD --export_bundle DIR --export_bundle_batch
    BATCH``, then ``scripts/serve_bundle.py`` in a fresh process given only
    DIR and an .npy of SERVE_REQUESTS images, under SERVE_CLIENTS
    closed-loop clients, TF32 off as here (counters reset there just before
    the clients): K4,
    K1 and K2 (K2b for bf16) once per group and K3 must launch; each result
    against the live detector (``det``, ``det16``) and the bundle's method
    on the same stacked batch (``_serve_check_rows``): counts, classes and
    verdicts equal, floats bit for bit. Then a bundle exported from the CPU detector with the same
    weights, served on the card (K4, K1, K2 must launch), against the f32
    bundle served on the CPU, image by image within REF_LIMITS. -> the
    launches of the phase's runs on the card."""
    import copy
    import pickle
    import zipfile
    from pathlib import Path
    from unittest import mock

    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval as E
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.utils import export as XE

    t_phase = time.perf_counter()
    paths = (C.RESULTS_PATH, C.STORAGE_PATH)
    C.RESULTS_PATH, C.STORAGE_PATH = root / "bundle_results", root / "bundle_storage"
    ckpt = root / "v8l_serve"
    yamls = [str(root / split / "sweep_ood.yaml") for split in ("ind", "ood")]
    requests = np.concatenate(make_batches(np.random.default_rng(SEED + 40),
                                           SERVE_REQUESTS // BATCH))
    np.save(root / "requests.npy", requests)
    failures, bundles, launches = [], {}, []
    real_export = XE.export_serving_bundle
    try:
        for label, live, extra in (("f32", det, []), ("bf16", det16, ["--bf16"])):
            out_dir = root / f"bundle_{label}"
            export = {}

            def timed_export(*a, **kw):
                t = time.perf_counter()
                p = real_export(*a, **kw)
                export["export_s"] = time.perf_counter() - t
                return p

            before, t0 = read_counters(), time.perf_counter()
            with mock.patch.object(XE, "export_serving_bundle", timed_export):
                E.main(["--ood_method", BUNDLE_METHOD, "--model_path", str(ckpt),
                        "--ind_dataset", yamls[0], "--ood_datasets", yamls[1],
                        "--img_size", str(IMG), "--batch_size", str(BATCH),
                        "--conf_thr_train", str(CONF), "--conf_thr_test", str(CONF),
                        "--device", "0", "--name", "chip_smoke_bundle", *extra,
                        "--export_bundle", str(out_dir), "--export_bundle_batch", str(BATCH)])
            torch.cuda.synchronize()
            launches.append(_delta(before))
            cli_s = time.perf_counter() - t0
            files = {p.name: p.stat().st_size for p in out_dir.iterdir()}
            with zipfile.ZipFile(out_dir / "model.pt2") as z:  # the archive's parts
                parts = {}
                for info in z.infolist():
                    key = "/".join(info.filename.split("/")[1:3])
                    parts[key] = parts.get(key, 0) + info.file_size
            proc = subprocess.run(
                [sys.executable, "-m", "ood_in_object_detection_torch.scripts.serve_bundle",
                 "--bundle", str(out_dir), "--images", str(root / "requests.npy"),
                 "--out", str(out_dir / "served.pkl"), "--clients", str(SERVE_CLIENTS),
                 "--max_wait_ms", str(SERVE_WAIT_MS)],
                cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"serve_bundle ({label}) failed (rc {proc.returncode}):\n"
                                     f"{proc.stderr[-3000:]}")
            report = json.loads(proc.stdout.strip().splitlines()[-1])
            served = pickle.loads((out_dir / "served.pkl").read_bytes())
            method = pickle.loads((out_dir / "ood_method.pkl").read_bytes())
            mismatches, first = 0, None
            for rows in served["groups"]:
                batch = np.zeros((BATCH, IMG, IMG, 3), np.uint8)
                batch[:len(rows)] = requests[rows]
                mismatches += _serve_check_rows(torch, live, method, batch, rows,
                                                served["results"])["mismatches"]
                if first is None and len(rows) == BATCH:
                    first = batch
            got = report["launches"]
            k2 = "roi_contract_bf16" if label == "bf16" else "roi_contract"
            per_group = report["launches_per_group"]
            if (per_group["fused_stem"], per_group["greedy_keep"], per_group[k2]) != (1, 1, 3) \
                    or got["roi_contract" if label == "bf16" else "roi_contract_bf16"] \
                    or not got["min_group_distances"]:
                failures.append(f"{label} bundle: K4, K1, {k2} not once a group (K2 once a "
                                f"level) or K3 not launched: {got}")
            if report["unanswered"] or report["failed"] or report["imports_checkpoint_reader"]:
                failures.append(f"{label} bundle server: {report['unanswered']} unanswered, "
                                f"{report['failed']}, checkpoint reader imported "
                                f"{report['imports_checkpoint_reader']}")
            if mismatches:
                failures.append(f"{label} bundle against the live detector: {mismatches} of "
                                f"{SERVE_REQUESTS} results differ")
            bundles[label] = dict(dir=out_dir, first=first, entry=dict(
                cli_s=cli_s, export_s=export.get("export_s"), files_bytes=files,
                model_pt2_parts_bytes=parts, cli_launches=launches[-1], serve=report,
                mismatches=mismatches))

        # a bundle exported on the CPU served on the card, against the card's
        # f32 bundle served on the CPU, on the first full served group
        batch = bundles["f32"]["first"]
        if batch is None:
            raise AssertionError("e2e_bundle: the f32 bundle served no full group")
        cpu_det = Detector(model=copy.deepcopy(det.model).cpu(), img_size=IMG)
        t0 = time.perf_counter()
        cpu_dir = XE.export_serving_bundle(cpu_det, None, root / "bundle_cpu", batch=BATCH,
                                           conf_thres=CONF)
        cpu_export_s = time.perf_counter() - t0
        x = torch.from_numpy(batch).float() * (1.0 / 255.0)
        t0 = time.perf_counter()
        on_card, _, _ = XE.load_serving_bundle(cpu_dir)
        torch.cuda.synchronize()
        card_load_s = time.perf_counter() - t0
        before = read_counters()
        with torch.no_grad():
            g = on_card(x.to(DEVICE))
        torch.cuda.synchronize()
        launches.append(_delta(before))
        if not all(launches[-1][k] for k in ("fused_stem", "greedy_keep", "roi_contract")):
            failures.append(f"the CPU's bundle on the card did not launch K4, K1, K2: "
                            f"{launches[-1]}")
        on_cpu, _, _ = XE.load_serving_bundle(bundles["f32"]["dir"], device="cpu")
        t0 = time.perf_counter()
        with torch.no_grad():
            c = on_cpu(x)
        cpu_run_s = time.perf_counter() - t0
        limits, readings = REF_LIMITS[MODEL], []
        for i in range(BATCH):
            # the bundle returns no raw head maps: their limit is not read here
            r = detection_errors(torch, g, c, i, 0.0)
            readings.append(r)
            if not within_ref_limits(r, limits):
                failures.append(f"CPU bundle on the card against the card's bundle on the "
                                f"CPU, image {i}: {r}")
        neck_rel = max(float((a.cpu().float() - b.float()).abs().max() / b.float().abs().max())
                       for a, b in zip(g.neck, c.neck))
        worst = {k: (min if k == "overlap" else max)(r["errors"][k] for r in readings)
                 for k in readings[0]["errors"]}
        cross = dict(cpu_export_s=cpu_export_s, card_load_s=card_load_s, cpu_run_s=cpu_run_s,
                     launches_on_card=launches[-1], worst=worst, neck_map_rel_err=neck_rel,
                     limits=limits, cls_equal=all(r["cls_equal"] for r in readings),
                     detections_card=sum(r["detections_card"] for r in readings),
                     detections_cpu=sum(r["detections_cpu"] for r in readings))
    finally:
        C.RESULTS_PATH, C.STORAGE_PATH = paths
    emit("e2e_bundle", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, method=BUNDLE_METHOD,
         card=env["nvidia_smi"], f32=bundles["f32"]["entry"],
         bf16=bundles["bf16"]["entry"], cpu_card=cross,
         phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_bundle: " + "; ".join(failures))
    served = [{k: b["entry"]["serve"]["launches"].get(k, 0) for k in launches[0]}
              for b in bundles.values()]
    return _added(*launches, *served)


# data parallelism (e2e_dp): predict over two meshes, cli.ood_eval
# --data_parallel, and the batch-16 train step on a process group
DP_KERNELS = ("greedy_keep", "roi_contract", "fused_stem")
# predict_sharded against Detector.predict of the same batch of 8 on the
# card: integer outputs (valid, classes, anchors, levels) equal; boxes in
# px, confidences absolute, RoI and exact taps as a share of their largest
# magnitude. Shards of 4 against the batch of 8 differ only where cuDNN picks
# another algorithm for another batch size.
DP_PREDICT_LIMITS = {"boxes_px": 1e-2, "conf": 1e-5, "taps_rel": 1e-4}
# the data-parallel train step against the single-process step on the same
# global batch (TRAIN_BATCH) and weights, by TRAIN_REF_LIMITS's measures:
# loss terms (relative) and the update of all trained tensors together (L2
# of the difference over L2 of the single-process update). Set from
# `python3 chip_smoke.py --only e2e_dp --reference-seeds 2` (dp_spread; two
# gloo ranks of 8 on one card, seeds 0-1; PERF.md section 6): sound
# loss <= 7.7e-7, update 1.07e-3 and 5.32e-3 (cuDNN picks other algorithms
# for batch 8 than for 16: with PyTorch's own convolutions the update reads
# 5.5e-4 and 6.5e-4); each rank's BatchNorm on its own rows (the fault)
# moves the loss by >= 4.0e-3 and the update by >= 1.05
DP_TRAIN_LIMITS = {"loss_rel": 3e-4, "update_rel": 2e-2}
DP_TRAIN_STEPS = 3  # timed steps after the compared one
# a planted fault (train_fault) moves the loss or the update at least this
# many times its limit
TRAIN_FAULT_FACTOR = 10.0


def read_device_counters() -> dict:
    """{kernel: {card index: launches}} of K1, K2, K2b and K4."""
    return {k: dict(getattr(fn, attr + "_by_device"))
            for k, (fn, attr) in counters().items() if hasattr(fn, attr + "_by_device")}


def state_digest(torch, state) -> str:
    """SHA-1 of every tensor of a TrainState and its step."""
    import hashlib

    from ood_in_object_detection_torch.train import trainer as TTR

    h = hashlib.sha1(str(state.step).encode())
    for t in TTR.state_tensors(state):
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class TrainWorld(NamedTuple):
    """A training world of train_rank (e2e_dp's NCCL ranks, dp_spread,
    e2e_sp_train): the mesh of the spawned ranks' devices shaped by
    ``axes`` (empty: ``data`` over every entry), the batch-16 step of MODEL
    seeded with ``seed`` held to the single-process step saved at ``ref``
    (dp_single_ref with the same ``seed`` and ``cudnn``; ``cudnn`` False
    runs PyTorch's own convolutions, the same for any batch size). After
    the checked step, each from the saved start: a step with remat
    (``remat``) and one under each planted fault of ``faults``
    (train_fault); then ``timed`` timed steps."""
    key: str
    axes: dict
    ref: str
    timed: int = 0
    remat: bool = False
    faults: tuple = ()
    seed: int = SEED
    cudnn: bool = True


@contextlib.contextmanager
def train_fault(kind: str):
    """Plant one fault for the steps inside: ``local_bn`` (each rank's
    BatchNorm statistics over its own rows, the fault the global batch's
    statistics exist to avoid), ``no_halo_grad`` (each halo row's gradient
    dropped, not returned to its owner), ``loss_gather_summed`` (the head's
    gather for the loss summed over sp, so every rank's gradient counts
    every rank's loss), ``no_tp_input_reduce`` (the split convs' input
    gradient not summed over model)."""
    from ood_in_object_detection_torch.models import layers as L
    from ood_in_object_detection_torch.parallel import distributed as D
    from ood_in_object_detection_torch.parallel import spatial

    if kind == "local_bn":
        owner, attr, fault = L, "bn_axis", lambda: None
    elif kind == "no_halo_grad":
        owner, attr = D._HaloWindow, "backward"

        def fault(ctx, g):
            plan = ctx.plan
            dx = g.new_zeros(ctx.shape)
            a, b = plan.own
            if a < b:
                dx[..., a - plan.start:b - plan.start, :] = g[..., a - plan.lo:b - plan.lo, :]
            return dx, None, None, None, None
        fault = staticmethod(fault)
    elif kind == "loss_gather_summed":
        owner, attr = spatial.RankShard, "gather_outputs"

        def fault(self, maps):
            return [self.gather(m, summed=True)[0] for m in maps]
    elif kind == "no_tp_input_reduce":
        owner, attr = D._ToModel, "backward"
        fault = staticmethod(lambda ctx, g: (g, None))
    else:
        raise ValueError(kind)
    sound = vars(owner)[attr]
    setattr(owner, attr, fault)
    try:
        yield
    finally:
        setattr(owner, attr, sound)


def train_world(torch, rank: int, devices, world: TrainWorld, batch, ref) -> dict:
    """One TrainWorld on this rank: a seeded MODEL placed by shard_state on
    the world's mesh, make_sharded_train_step on this rank's part of
    ``batch`` (device_put_batch: its rows, on sp its slab). The first step
    is checked on rank 0 against the single-process step ``ref`` on the
    state gather_state gathers (twice: the digests must agree); then the
    world's remat and fault steps, read the same way; then its timed steps
    (CUDA events, as the first step is too; on the CPU the host's clock).
    -> this rank's readings: loss terms, digest, halo and gather counts of
    the first step each way, the gradient all-reduce's seconds and MB, peak
    memory, step ms; rank 0 also the checks."""
    from ood_in_object_detection_torch.models import build_model, init_weights
    from ood_in_object_detection_torch.parallel import device_put_batch, make_mesh
    from ood_in_object_detection_torch.train import trainer as TTR

    stamps = {"entry": time.time()}
    torch.backends.cudnn.enabled = world.cudnn
    mesh = make_mesh(devices=devices, **world.axes)
    place = mesh.place(rank)
    model = build_model(MODEL, nc=NC)
    init_weights(model, torch.Generator().manual_seed(world.seed))
    model.to(place.device)
    p0 = {n: p.detach().clone() for n, p in TTR.trained_parameters(model)}
    cfg = TTR.TrainConfig()
    state = TTR.shard_state(TTR.init_state(model, cfg), mesh)
    start = ({k: v.clone() for k, v in model.state_dict().items()},
             {k: v.clone() for k, v in state.ema.items()})
    timings = {}
    step = TTR.make_sharded_train_step(model, cfg, mesh, timings=timings)
    local = device_put_batch(batch, mesh)[0]
    on_card = place.device.type == "cuda"
    stamps["placed"] = time.time()

    def restart():
        model.load_state_dict(start[0])
        state.ema = {k: v.clone() for k, v in start[1].items()}
        state.optimizer.state.clear()
        state.step = 0

    def reading(lb, digest=False) -> dict:
        """Loss terms; on rank 0 against the reference, on the gathered
        state (every rank gathers), and its digest."""
        full = TTR.gather_state(state, mesh)
        out = dict(loss={k: float(getattr(lb, k)) for k in ("total", "box", "cls", "dfl")})
        if full is None:
            return out
        out["loss_rel"] = max(abs(out["loss"][k] - v) / abs(v) for k, v in ref["loss"].items())
        num = den = 0.0
        for n, p in TTR.trained_parameters(full.model):
            want = ref["params"][n].to(p.device) - p0[n]
            num += float(((p.detach() - p0[n]) - want).double().pow(2).sum())
            den += float(want.double().pow(2).sum())
        out["update_rel"] = (num / den) ** 0.5
        if digest:
            out["gathered_digest"] = state_digest(torch, full)
        return out

    if on_card:
        torch.cuda.reset_peak_memory_stats()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
    else:
        t_host = time.perf_counter()
    state, lb = step(state, local)
    if on_card:
        t1.record()
        torch.cuda.synchronize()
        first_ms = t0.elapsed_time(t1)
    else:
        first_ms = (time.perf_counter() - t_host) * 1e3
    stamps["first_step"] = time.time()
    first = reading(lb, digest=True)
    again = TTR.gather_state(state, mesh)
    out = dict(rank=rank, place=place._replace(device=str(place.device))._asdict(),
               backend=torch.distributed.get_backend(), local_images=list(local["images"].shape),
               first=first, first_step_ms=first_ms, digest=state_digest(torch, state),
               sp=timings.get("sp", [None])[0], all_reduce_s=list(timings.get("all_reduce_s", [])),
               all_reduce_mb=timings.get("all_reduce_bytes", 0) / 1e6)
    if again is not None:
        first["gather_again_equal"] = state_digest(torch, again) == first["gathered_digest"]
    del again
    variants = {}
    if world.remat:
        restart()
        cfg.remat = True
        try:
            state, lb = step(state, local)
        finally:
            cfg.remat = False
        variants["remat"] = reading(lb)
    for kind in world.faults:
        restart()
        with train_fault(kind):
            state, lb = step(state, local)
        variants[kind] = reading(lb)
    out["variants"] = variants
    stamps["variants"] = time.time()
    if world.timed and on_card:
        ms = cuda_ms(lambda: step(state, local), reps=world.timed, warmup=0)
    elif world.timed:
        t_host = time.perf_counter()
        for _ in range(world.timed):
            step(state, local)
        ms = (time.perf_counter() - t_host) * 1e3 / world.timed
    if world.timed:
        out.update(step_ms=ms, images_per_s=len(batch["images"]) * 1000.0 / ms)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    out["stamps"] = dict(stamps, timed=time.time())
    torch.backends.cudnn.enabled = True
    return out


def train_rank(rank: int, world: int, devices, worlds, batch_size: int) -> dict:
    """One rank of a training spawn (parallel/distributed.py:spawn): the
    TrainWorlds ``worlds`` in turn on the same ranks, each on
    overfit_batch(batch_size) (made here, not sent) -> {key: train_world's
    readings}."""
    import torch

    batch = overfit_batch(batch_size)
    refs, out = {}, {}
    for w in worlds:
        if rank == 0 and w.ref not in refs:
            refs[w.ref] = torch.load(w.ref, weights_only=True)
        out[w.key] = train_world(torch, rank, devices, w, batch, refs.get(w.ref))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def train_summary(w: TrainWorld, ranks, wall0, batch_size) -> dict:
    """A world's line from its ranks' readings; ``ok``: rank 0's first step
    and remat step within DP_TRAIN_LIMITS, the gathered state equal on a
    second gather, the ranks of each model index equal (digests), each
    planted fault at least TRAIN_FAULT_FACTOR x over its limit, finite
    losses."""
    r0 = ranks[0]
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["place"]["model"], set()).add(r["digest"])

    def factor(v):
        return max(v["loss_rel"] / DP_TRAIN_LIMITS["loss_rel"],
                   v["update_rel"] / DP_TRAIN_LIMITS["update_rel"])

    variants = r0["variants"]
    faults = {k: dict(v, factor=factor(v)) for k, v in variants.items() if k != "remat"}
    sound = [v for v in (r0["first"], variants.get("remat")) if v is not None]
    ok = bool(all(factor(v) <= 1.0 for v in sound) and r0["first"].get("gather_again_equal")
              and all(len(d) == 1 for d in by_model.values())
              and all(v["factor"] >= TRAIN_FAULT_FACTOR for v in faults.values())
              and all(np.isfinite(list(r["first"]["loss"].values())).all() for r in ranks))
    timed = [r["step_ms"] for r in ranks if "step_ms" in r]
    first_ms = max(r["first_step_ms"] for r in ranks)

    def per_rank(direction, field, scale=1.0):
        return [(r["sp"] or {}).get(direction, {}).get(field, 0) * scale for r in ranks]

    return dict(world=w.key, axes=w.axes, ranks=len(ranks), backend=r0["backend"],
                seed=w.seed, cudnn=w.cudnn, global_batch=batch_size,
                local_images=r0["local_images"], seconds=r0["stamps"]["timed"] - wall0,
                loss_rel=r0["first"]["loss_rel"], update_rel=r0["first"]["update_rel"],
                gather_again_equal=r0["first"].get("gather_again_equal"),
                remat=variants.get("remat"), faults=faults,
                model_index_digests_equal=all(len(d) == 1 for d in by_model.values()),
                first_step_ms=first_ms, first_images_per_s=batch_size * 1e3 / first_ms,
                step_ms=max(timed) if timed else None,
                step_ms_ranks=timed,
                images_per_s=batch_size * 1000.0 / max(timed) if timed else None,
                halo_mb_forward=per_rank("forward", "halo_bytes", 1e-6),
                halo_mb_backward=per_rank("backward", "halo_bytes", 1e-6),
                exchanges_forward=per_rank("forward", "exchanges"),
                exchanges_backward=per_rank("backward", "exchanges"),
                gather_mb_forward=per_rank("forward", "gather_bytes", 1e-6),
                gather_mb_backward=per_rank("backward", "gather_bytes", 1e-6),
                wait_s_forward=per_rank("forward", "wait_s"),
                wait_s_backward=per_rank("backward", "wait_s"),
                all_reduce_mb=r0["all_reduce_mb"], all_reduce_s=[r["all_reduce_s"] for r in ranks],
                peak_memory_gb=[r["peak_memory_gb"] for r in ranks],
                stage_s={k: round(v - wall0, 2) for k, v in r0["stamps"].items()}, ok=ok)


def train_run(torch, devices, worlds, batch_size: int) -> dict:
    """Spawn one rank per entry of ``devices`` (PyTorch's own intra-op
    threads a rank) and run the TrainWorlds ``worlds`` on them in turn
    (train_rank) -> {key: train_summary}. A rank that fails or hangs
    raises, named (spawn)."""
    from ood_in_object_detection_torch.parallel.distributed import spawn

    wall0 = time.time()
    ranks = spawn(train_rank, devices, args=(devices, list(worlds), batch_size), join_timeout=900)
    out = {}
    for w in worlds:
        out[w.key] = train_summary(w, [r[w.key] for r in ranks], wall0, batch_size)
        wall0 = ranks[0][w.key]["stamps"]["timed"]
    return out


def dp_single_ref(torch, batch, path, seed=SEED, cudnn=True):
    """The single-process train step of a seeded MODEL on the global
    ``batch``, its loss terms and trained parameters saved at ``path`` for
    a TrainWorld; -> (model, cfg, state) after the step."""
    from ood_in_object_detection_torch.models import build_model, init_weights
    from ood_in_object_detection_torch.train import trainer as TTR

    model = build_model(MODEL, nc=NC)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(DEVICE)
    cfg = TTR.TrainConfig()
    torch.backends.cudnn.enabled = cudnn
    try:
        state, lb = TTR.train_step(model, cfg, TTR.init_state(model, cfg), batch)
    finally:
        torch.backends.cudnn.enabled = True
    torch.save(dict(loss={k: float(getattr(lb, k)) for k in ("total", "box", "cls", "dfl")},
                    params={n: p.detach().cpu() for n, p in TTR.trained_parameters(model)}),
               path)
    return model, cfg, state


def dp_spread(torch, n_seeds: int) -> None:
    """The readings DP_TRAIN_LIMITS stand on: on ``n_seeds`` seeds of the
    weights, the batch-16 step on two gloo ranks of one card against the
    single-process step with cuDNN (sound), without it (PyTorch's own
    convolutions, the same arithmetic for any batch size), and with each
    rank's BatchNorm statistics over its own rows (local_bn, the fault);
    one line a reading, then the worst sound and the least faulty. Asserts
    nothing."""
    import tempfile
    from pathlib import Path

    batch = overfit_batch(TRAIN_BATCH)
    worst = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_spread_") as tmp:
        for s in range(n_seeds):
            refs = {}
            for cudnn in (True, False):
                refs[cudnn] = str(Path(tmp) / f"ref_{s}_{cudnn}.pt")
                dp_single_ref(torch, batch, refs[cudnn], seed=SEED + s, cudnn=cudnn)
                torch.cuda.empty_cache()
            r = train_run(torch, [0, 0], [
                TrainWorld("sound", {}, refs[True], faults=("local_bn",), seed=SEED + s),
                TrainWorld("cudnn_off", {}, refs[False], seed=SEED + s, cudnn=False)],
                TRAIN_BATCH)
            for mode, world, v in (("sound", "sound", r["sound"]),
                                   ("cudnn_off", "cudnn_off", r["cudnn_off"]),
                                   ("local_bn", "sound", r["sound"]["faults"]["local_bn"])):
                emit("dp_train_reading", seed=s, mode=mode, loss_rel=v["loss_rel"],
                     update_rel=v["update_rel"],
                     ranks_equal=r[world]["model_index_digests_equal"])
                w = worst.setdefault(mode, dict(loss_rel=[], update_rel=[]))
                w["loss_rel"].append(v["loss_rel"])
                w["update_rel"].append(v["update_rel"])
    emit("dp_train_spread", seeds=n_seeds, limits=DP_TRAIN_LIMITS,
         worst={m: {k: max(v) for k, v in worst[m].items()} for m in ("sound", "cudnn_off")},
         fault_least={k: min(v) for k, v in worst["local_bn"].items()})


def dp_predict_check(torch, det, images, mesh) -> dict:
    """predict_sharded on ``mesh`` against det.predict of the same batch,
    the kernels' launches per card index counted around the sharded run."""
    from ood_in_object_detection_torch.parallel import batch_sharding

    want = det.predict(images, conf_thres=CONF)
    reset_counters()
    got = det.predict_sharded(images, mesh, conf_thres=CONF)
    torch.cuda.synchronize()
    launches, by_device = read_counters(), read_device_counters()
    ints = all(torch.equal(getattr(got.det, f), getattr(want.det, f))
               for f in ("valid", "cls", "anchor_idx")) and \
        torch.equal(got.stride_level, want.stride_level)
    valid = want.det.valid

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    spread = dict(boxes_px=float((got.det.boxes - want.det.boxes)[valid].abs().max()),
                  conf=float((got.det.conf - want.det.conf).abs().max()),
                  roi_rel=rel(got.roi_feats, want.roi_feats),
                  exact_rel=rel(got.exact_feats, want.exact_feats),
                  neck_rel=max(rel(a, b) for a, b in zip(got.neck, want.neck)))
    ok = ints and spread["boxes_px"] <= DP_PREDICT_LIMITS["boxes_px"] and \
        spread["conf"] <= DP_PREDICT_LIMITS["conf"] and \
        max(spread["roi_rel"], spread["exact_rel"]) <= DP_PREDICT_LIMITS["taps_rel"] and \
        got.det.boxes.device == mesh.batch_devices[0]
    shards = len(batch_sharding(mesh).devices)
    return dict(mesh=str(mesh), shards=shards, ints_equal=ints, spread=spread, ok=ok,
                detections=int(valid.sum()), launches=launches, launches_by_device=by_device,
                launched_everywhere=all(
                    sum(by_device[k].values()) == launches[k] and
                    all(by_device[k].get(d.index, 0) for d in mesh.batch_devices)
                    for k in DP_KERNELS),
                sharded_ms=cuda_ms(lambda: det.predict_sharded(images, mesh, conf_thres=CONF),
                                   reps=10),
                predict_ms=cuda_ms(lambda: det.predict(images, conf_thres=CONF), reps=10))


def phase_e2e_dp(torch, det, ind, ood, root, env) -> dict:
    """Data parallelism on e2e's detector and weights: predict_sharded on a
    mesh of every visible card and on [cuda:0, cuda:0] against
    Detector.predict (DP_PREDICT_LIMITS; K4, K1 and K2 launched on every
    replica's card); cli.ood_eval --data_parallel (over card 0 twice where
    it is the only card) on e2e_serve's checkpoint and datasets, its MSP
    and Cosine_cl_stride rows equal to the run without the flag; the
    batch-16 train step on a process group of ``device_count()`` ranks
    (NCCL; with one card ``--device 0,0``'s two gloo ranks run in
    e2e_sp_train, world data2) against the single-process step on the same
    global batch
    (DP_TRAIN_LIMITS), every rank's state equal. -> the launches of the
    phase's predict runs."""
    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval as E
    from ood_in_object_detection_torch.parallel import make_mesh
    from ood_in_object_detection_torch.train import trainer as TTR

    t_phase = time.perf_counter()
    failures, launches = [], []
    n_cards = torch.cuda.device_count()
    images = ood[0]["images"]

    # 1. predict over two meshes
    predict = {}
    for key, mesh in (("all_cards", make_mesh()), ("cuda0_twice", make_mesh(devices=[0, 0]))):
        r = predict[key] = dp_predict_check(torch, det, images, mesh)
        launches.append(r["launches"])
        if not (r["ok"] and r["launched_everywhere"]):
            failures.append(f"predict_sharded {key}: {r}")

    # 2. the eval CLI with and without --data_parallel (over every card, or
    # over card 0 twice where it is the only one: two shards either way)
    paths = (C.RESULTS_PATH, C.STORAGE_PATH)
    evals = {}
    dp_device = "0,0" if n_cards == 1 else "0"
    try:
        for flag in (("--device", "0"), ("--device", dp_device, "--data_parallel")):
            key = "data_parallel" if len(flag) > 2 else "single"
            C.RESULTS_PATH, C.STORAGE_PATH = root / f"dp_{key}_results", root / f"dp_{key}_storage"
            for m in ("MSP", "Cosine_cl_stride"):
                before, t0 = read_counters(), time.perf_counter()
                (row,) = E.main(["--ood_method", m, "--model_path", str(root / "v8l_serve"),
                                 "--ind_dataset", str(root / "ind" / "sweep_ood.yaml"),
                                 "--ood_datasets", str(root / "ood" / "sweep_ood.yaml"),
                                 "--img_size", str(IMG), "--batch_size", str(BATCH),
                                 "--conf_thr_train", str(CONF), "--conf_thr_test", str(CONF),
                                 "--name", f"chip_smoke_dp_{key}", *flag])
                torch.cuda.synchronize()
                launches.append(_delta(before))
                evals.setdefault(m, {})[key] = dict(
                    seconds=time.perf_counter() - t0, device=flag[1],
                    owod={k: row[k] for k in row if k.endswith("(COOD)")})
    finally:
        C.RESULTS_PATH, C.STORAGE_PATH = paths
    for m, r in evals.items():
        a, b = r["data_parallel"]["owod"], r["single"]["owod"]
        r["equal"] = a.keys() == b.keys() and all(
            np.isclose(a[k], b[k], rtol=1e-5, atol=1e-7) for k in a)
        if not r["equal"] or len(a) != 4:
            failures.append(f"ood_eval --data_parallel {m}: {a} against {b}")

    # 3. the train step: single process, then the process groups
    batch = overfit_batch(TRAIN_BATCH)
    ref_path = root / "dp_train_ref.pt"
    model, cfg, state = dp_single_ref(torch, batch, ref_path)
    single_ms = cuda_ms(lambda: TTR.train_step(model, cfg, state, batch),
                        reps=DP_TRAIN_STEPS, warmup=0)
    del model, state
    torch.cuda.empty_cache()
    train = {"single_step_ms": single_ms}
    if n_cards == 1:  # a world of one rank runs the single-device step, no collective
        train["nccl_all_cards"] = "not run: one card is visible"
        train["gloo_cuda0_twice"] = "run by e2e_sp_train (world data2), from the same reference"
        worlds = []
    else:
        worlds = [("nccl_all_cards", list(range(n_cards)))]
    for key, devices in worlds:
        try:
            r = train[key] = train_run(torch, devices, [TrainWorld(
                key, {}, str(ref_path), timed=DP_TRAIN_STEPS)], TRAIN_BATCH)[key]
        except Exception as e:  # noqa: BLE001 (a rank that fails fails the phase)
            failures.append(f"train {key}: {e}")
            continue
        if not r["ok"]:
            failures.append(f"train {key}: {r}")
    emit("e2e_dp", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, cards=n_cards,
         card=env["nvidia_smi"], predict=predict, ood_eval=evals, train_batch=TRAIN_BATCH,
         train=train, predict_limits=DP_PREDICT_LIMITS, train_limits=DP_TRAIN_LIMITS,
         phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_dp: " + "; ".join(failures))
    return _added(*launches)


# spatial parallelism (e2e_sp): predict and the server over sp meshes, one
# card named several times where it is the only one
SP_KERNELS = ("greedy_keep", "roi_contract", "fused_stem")
SP_SERVE_REQUESTS = 16
# predict_sharded against Detector.predict of the same images. Where the
# neck maps come out bit-equal, the rest must too: integer outputs equal,
# DP_PREDICT_LIMITS. cuDNN may run another algorithm on a slab's shape than
# on the whole map's (FFT convolutions, DSE::regular_fft_*, on f32 slabs at
# batch 1 and 8 on the H100: sp_spread's sharded_only_kernels), and these
# random networks amplify a difference in the last bits layer after layer
# (card against CPU: REF_LIMITS), so detections near a tie or at the 300th
# place change sides (cudnn.benchmark, cudnn.deterministic and
# CUDNN_CONV_WSCAP_DBG=0 leave the FFT choice as it is; PyTorch's own
# convolutions differ too, by shape). So every f32 run is held twice:
# - layer by layer (sp_layer_spread): each layer of the sharded forward
#   against the same layer run unsharded on the sharded run's own input to
#   it, as a share of the layer output's largest magnitude, within
#   SP_LAYER_REL. No amplification: a sound run differs by one layer's
#   rounding, a halo fault shows at its own layer (sp_fault's window_shift
#   and pool_no_halo are planted in every e2e_sp run and must fail it);
# - end to end, per model (SP_F32_LIMITS): the neck maps' difference as a
#   share of their largest magnitude, the share of detection slots whose
#   valid / class / anchor differ, and boxes (px), confidences and RoI /
#   exact taps (share of scale) over the slots that agree.
# Both set from `python3 chip_smoke.py --only e2e_sp --reference-seeds 2`
# (sp_spread: yolov8l seeds 0-1 at sp 2 and 4, batch 1 and 8, the families
# at sp 2 batch 1; sound and with each of SP_FAULTS; PERF.md section 6) and
# the e2e_sp runs on the H100. Layers: sound runs read <= 4.1e-6 (yolov8l,
# sp 2 at batch 8; FFT on the slab), faults >= 8.5e-4 (pool_edge_zero in
# yolo11l; window_shift >= 0.46, pool_no_halo >= 0.44). End to end, sound
# worst -> limit (about twice it), least faulty: yolov8l neck 4.8e-4 -> 1e-3
# (pool_edge_zero 2.3e-3), slots 0.049 -> 0.1, boxes 0.53 px -> 1, conf
# 1.3e-5 -> 3e-5, taps 4.6e-3 -> 1e-2; yolov9c 5.3e-4, 0.073, 0.32 px,
# 3.0e-6, 1.8e-3 (pool_edge_zero neck 9.9e-3); yolov10l, which amplifies
# most (REF_LIMITS), 1.2e-3, 0.153, 1.03 px, 3.1e-5, 4.5e-3 (pool_edge_zero
# neck 4.4e-3); yolo11l and yolo12l run the same convolution algorithms on
# a slab as on the whole map and read 0 on every seed: bit-equal.
SP_LAYER_REL = 1e-4
SP_F32_LIMITS = {
    "yolov8l": {"neck_rel": 1e-3, "flip_share": 0.1, "boxes_px": 1.0, "conf": 3e-5,
                "taps_rel": 1e-2},
    "yolov9c": {"neck_rel": 1.5e-3, "flip_share": 0.15, "boxes_px": 1.0, "conf": 1e-5,
                "taps_rel": 5e-3},
    "yolov10l": {"neck_rel": 2.5e-3, "flip_share": 0.3, "boxes_px": 2.0, "conf": 6e-5,
                 "taps_rel": 1e-2},
    "yolo11l": {"neck_rel": 0.0, "flip_share": 0.0, "boxes_px": 0.0, "conf": 0.0,
                "taps_rel": 0.0},
    "yolo12l": {"neck_rel": 0.0, "flip_share": 0.0, "boxes_px": 0.0, "conf": 0.0,
                "taps_rel": 0.0},
}
# bf16 at batch 8 (the bf16 check's) reads 0.0 on both seeds, bit-equal:
# its limits are 0. (bf16 at batch 1 reads neck 0.39-0.59 and 99 % of
# slots against the fault's >= 0.81: a slab there takes another bf16 GEMM
# tile, and a random bf16 network turns one rounding into other detections.)
SP_BF16_LIMITS = {"neck_rel": 0.0, "flip_share": 0.0, "boxes_px": 0.0, "conf": 0.0,
                  "taps_rel": 0.0}
SP_FAULTS = ("no_halos", "no_halo_first", "window_shift", "pool_no_halo", "pool_edge_zero")
CONV_KERNEL_MARKS = ("fprop", "fft", "winograd", "conv", "gemm", "gemv", "xmma")


def card0(n: int) -> list:
    """Mesh entries naming card 0 ``n`` times (the CPU in a rehearsal with
    DEVICE "cpu")."""
    return ["cpu"] * n if DEVICE == "cpu" else [0] * n


def sp_stats(det) -> dict:
    """The last sp run's exchange counts, rows and bytes taken from other
    shards (halos and gathers, over every shard) and the shards' host
    milliseconds at the barrier (sum and largest)."""
    shards = [s for g in det.last_sp_stats for s in g]
    return dict(exchanges_per_shard=max(s.exchanges for s in shards),
                halo_rows=sum(s.halo_rows for s in shards),
                halo_bytes=sum(s.halo_bytes for s in shards),
                gather_rows=sum(s.gather_rows for s in shards),
                gather_bytes=sum(s.gather_bytes for s in shards),
                barrier_wait_ms=sum(s.wait_s for s in shards) * 1e3,
                barrier_wait_ms_max_shard=max(s.wait_s for s in shards) * 1e3)


def sp_spread_of(torch, got, want) -> dict:
    """How far ``got`` lies from ``want``: the share of detection slots
    (valid in either) whose valid, class or anchor differ; over the slots
    valid in both with the same anchor, boxes (px), confidences and the
    RoI and exact taps as a share of their largest magnitude; the neck maps
    as a share of their largest magnitude."""
    a, b = got.det, want.det
    either = a.valid | b.valid
    same = (a.valid == b.valid) & (a.cls == b.cls) & (a.anchor_idx == b.anchor_idx)
    both = a.valid & b.valid & (a.anchor_idx == b.anchor_idx)

    def rel(x, y):
        return float((x.float() - y.float()).abs().max() / y.float().abs().max().clamp(min=1e-30))

    def worst(x, y):
        return float((x - y)[both].abs().max()) if bool(both.any()) else 0.0

    def taps(x, y):
        return rel(x[both], y[both]) if bool(both.any()) else 0.0

    taps_rel = max(taps(got.roi_feats, want.roi_feats), taps(got.exact_feats, want.exact_feats))
    return dict(flip_share=float((either & ~same).sum()) / max(1, int(either.sum())),
                boxes_px=worst(a.boxes, b.boxes), conf=worst(a.conf, b.conf),
                taps_rel=taps_rel,
                neck_rel=max(rel(x, y) for x, y in zip(got.neck, want.neck)))


def sp_within(spread, limits) -> bool:
    """Within DP_PREDICT_LIMITS's measures, no detection slot differing."""
    return all(spread[k] <= limits[k] for k in ("boxes_px", "conf", "taps_rel")) and \
        spread["flip_share"] == 0.0


def conv_kernels(torch, fn) -> set:
    """The convolution kernels (and GEMMs) one call of ``fn`` runs on the
    card, by name (torch.profiler)."""
    rows, _ = profile_rows(torch, fn, 1)
    return {k for _, k, _ in rows if any(m in k.lower() for m in CONV_KERNEL_MARKS)}


def sp_layer_spread(torch, det, images, mesh) -> dict:
    """Each top-level layer of predict_sharded's forward on ``mesh`` against
    the same layer run unsharded on the sharded run's own input to it (the
    shards' inputs joined over their rows and batch shards), as a share of
    the layer output's largest magnitude; on the fused stem route, the
    stem (layers 0 and 1: fused_stem on the whole image) against the
    shards' stem rows (layer 2's input). -> the worst layer and every
    layer's reading. The mesh's entries must be the model's own card (the
    forward hooks sit on its model, not on replicas)."""
    from ood_in_object_detection_torch.engine import normalise_images
    from ood_in_object_detection_torch.models.yolo import fused_stem
    from ood_in_object_detection_torch.parallel import spatial

    model = det.model
    seen = {}

    def hook(li):
        def record(_mod, args, out):
            shard = spatial.current()
            if shard is not None:
                seen[(li, id(shard.group.stats), shard.rank)] = (args[0], out)
        return record

    hooks = [m.register_forward_hook(hook(li)) for li, m in enumerate(model.model)]
    try:
        with torch.no_grad():
            det.predict_sharded(images, mesh, conf_thres=CONF)
    finally:
        for h in hooks:
            h.remove()
    groups = [id(g) for g in det.last_sp_stats]
    sp = len(det.last_sp_stats[0])

    def join(parts):  # [batch shard][sp shard] -> one map (or list of maps)
        first = parts[0][0]
        if isinstance(first, torch.Tensor):
            return torch.cat([torch.cat([p.to(det.device) for p in g], dim=-2) for g in parts])
        return [join([[p[i] for p in g] for g in parts]) for i in range(len(first))]

    def rel(x, y):
        if isinstance(y, torch.Tensor):
            return float((x.float() - y.float()).abs().max()
                         / y.float().abs().max().clamp(min=1e-30))
        return max(rel(a, b) for a, b in zip(x, y))

    layers = {}
    with torch.no_grad():
        for li in sorted({k[0] for k in seen}):
            recs = [[seen[(li, g, r)] for r in range(sp)] for g in groups]
            x = join([[rec[0] for rec in g] for g in recs])
            y = join([[rec[1] for rec in g] for g in recs])
            layers[str(li)] = rel(y, model.model[li](x))
        whole = normalise_images(torch.as_tensor(images).to(det.device))
        whole = whole.permute(0, 3, 1, 2).contiguous().to(model.compute_dtype)
        if 0 not in {k[0] for k in seen} and model.spec[2][0] == -1:
            recs = [[seen[(2, g, r)][0] for r in range(sp)] for g in groups]
            layers["stem"] = rel(join(recs), fused_stem(whole, model.model[0], model.model[1],
                                                        model.compute_dtype))
    worst = max(layers, key=layers.get)
    return dict(worst_layer=worst, worst_rel=layers[worst], layers=layers)


def sp_fault(kind: str, at: int = 0):
    """Plant a halo fault into parallel/spatial.Shard (``kind`` one of
    SP_FAULTS); -> a function that undoes it and returns how many of the
    shards' exchanges the fault changed.
    - no_halos: every shard takes zeros for its neighbours' rows, as if its
      slab were an image of its own;
    - no_halo_first: the same at the first exchange alone (the first conv
      after the stem);
    - window_shift: the ``at``-th window (a conv or pool taller than 1) of
      every shard reads its rows one row lower, the neighbours' included:
      one layer's halo off by a row;
    - pool_no_halo: max-pools take -inf for the neighbours' rows, padding at
      the shard's edge as at the image's (the pool rule left out);
    - pool_edge_zero: max-pools fill past the image's edge with 0 instead
      of -inf (changes a value only where an edge window holds no positive
      one)."""
    import torch

    from ood_in_object_detection_torch.parallel import spatial

    Shard, changed = spatial.Shard, []
    rows, halo_rows, window = Shard._rows, Shard._halo_rows, Shard.window

    def own_rows_only(self, parts, *args):
        if kind == "no_halos" or (kind == "no_halo_first" and self._gen == 1) or \
                getattr(self, "_fault_pool", False):
            changed.append(1)
            fill = float("-inf") if kind == "pool_no_halo" else 0.0
            parts = [p if j == self.rank else torch.full_like(p, fill)
                     for j, p in enumerate(parts)]
        return rows(self, parts, *args)

    def shifted(self, parts, starts, height, lo, hi, fill):
        self._fault_windows = getattr(self, "_fault_windows", 0) + 1
        if self._fault_windows == at:
            changed.append(1)
            return halo_rows(self, parts, starts, height, lo + 1, hi + 1,
                             0.0 if fill is None else fill)
        return halo_rows(self, parts, starts, height, lo, hi, fill)

    def pool_window(self, x, k, s, p, fill):
        if kind == "pool_edge_zero" and fill == float("-inf"):
            changed.append(1)
            fill = 0.0
        self._fault_pool = kind == "pool_no_halo" and fill == float("-inf")
        try:
            return window(self, x, k, s, p, fill)
        finally:
            self._fault_pool = False

    patches = {"no_halos": {"_rows": own_rows_only}, "no_halo_first": {"_rows": own_rows_only},
               "window_shift": {"_halo_rows": shifted},
               "pool_no_halo": {"window": pool_window, "_rows": own_rows_only},
               "pool_edge_zero": {"window": pool_window}}[kind]
    for name, fn in patches.items():
        setattr(Shard, name, fn)

    def undo():
        Shard._rows, Shard._halo_rows, Shard.window = rows, halo_rows, window
        return len(changed)

    return undo


def sp_windows(torch, det, images, mesh) -> int:
    """How many windows (convs and pools taller than 1) a shard of
    ``mesh`` takes in one forward: window_shift's middle is half of it."""
    from ood_in_object_detection_torch.parallel import spatial

    orig, counts = spatial.Shard._halo_rows, []

    def counting(self, *args):
        if self.rank == 0:
            counts.append(1)
        return orig(self, *args)

    spatial.Shard._halo_rows = counting
    try:
        with torch.no_grad():
            det.predict_sharded(images, mesh, conf_thres=CONF)
    finally:
        spatial.Shard._halo_rows = orig
    return len(counts) // len(det.last_sp_stats)


def sp_faulty_run(torch, det, images, mesh, kind: str, want, layers: bool) -> dict:
    """predict_sharded with ``kind`` planted (window_shift at the middle
    window): its spread against ``want`` and, with ``layers``, its
    layer-by-layer spread; ``changed``: the exchanges the fault changed (0:
    the model has no window it applies to)."""
    at = sp_windows(torch, det, images, mesh) // 2 if kind == "window_shift" else 0
    undo = sp_fault(kind, at)
    try:
        with torch.no_grad():
            got = det.predict_sharded(images, mesh, conf_thres=CONF)
        out = sp_spread_of(torch, got, want)
        if layers:
            lay = sp_layer_spread(torch, det, images, mesh)
            out.update(layer_worst=lay["worst_layer"], layer_rel=lay["worst_rel"])
    finally:
        changed = undo()
    return dict(out, fault=kind, at=at, changed=changed)


def sp_predict_check(torch, det, images, mesh, name=None) -> dict:
    """predict_sharded on an sp ``mesh`` against det.predict of the same
    images, the counters reset just before and read just after each. f32:
    every layer within SP_LAYER_REL of the unsharded layer on the same
    input (sp_layer_spread; where the mesh names the model's card alone)
    and the outputs within ``name``'s SP_F32_LIMITS; bf16: within
    SP_BF16_LIMITS (bit-equal). Where the neck maps are bit-equal, integer
    outputs equal and DP_PREDICT_LIMITS too. K4 launched once a slab, K1
    and K2 once a batch shard as often as predict launches them; ms of
    both (CUDA events), halo rows and bytes, barrier wait."""
    bf16 = det.model.compute_dtype == torch.bfloat16
    name = name or MODEL
    reset_counters()
    want = det.predict(images, conf_thres=CONF)
    torch.cuda.synchronize()
    per = read_counters()
    reset_counters()
    got = det.predict_sharded(images, mesh, conf_thres=CONF)
    torch.cuda.synchronize()
    launches = read_counters()
    stats = sp_stats(det)
    shards, sp = len(mesh.sp_groups), mesh.shape["sp"]
    k2 = "roi_contract_bf16" if bf16 else "roi_contract"
    expected = {"fused_stem": shards * sp, "greedy_keep": shards * per["greedy_keep"],
                k2: shards * per[k2]}
    spread = sp_spread_of(torch, got, want)
    ints = all(torch.equal(getattr(got.det, f), getattr(want.det, f))
               for f in ("valid", "cls", "anchor_idx")) and \
        torch.equal(got.stride_level, want.stride_level)
    limits = SP_BF16_LIMITS if bf16 else SP_F32_LIMITS[name]
    own_card = all(d == det.device for g in mesh.sp_groups for d in g)
    layers = sp_layer_spread(torch, det, images, mesh) if not bf16 and own_card else None
    exact = spread["neck_rel"] == 0.0
    ok = all(spread[k] <= v for k, v in limits.items()) and \
        (layers is None or layers["worst_rel"] <= SP_LAYER_REL) and \
        (not exact or (ints and sp_within(spread, DP_PREDICT_LIMITS))) and \
        got.det.boxes.device == mesh.batch_devices[0] and \
        all(launches[k] == v for k, v in expected.items())
    return dict(model=name, mesh=dict(mesh.shape),
                devices=[str(d) for d in mesh.devices.reshape(-1)],
                batch=int(images.shape[0]), dtype="bf16" if bf16 else "f32",
                neck_bit_equal=exact, ints_equal=ints,
                within_dp_predict_limits=bool(ints and sp_within(spread, DP_PREDICT_LIMITS)),
                spread=spread, limits=limits, layers=layers, layer_limit=SP_LAYER_REL,
                ok=bool(ok), detections=int(want.det.valid.sum()),
                launches={k: launches[k] for k in expected}, launches_expected=expected,
                sp=stats,
                sharded_ms=cuda_ms(lambda: det.predict_sharded(images, mesh, conf_thres=CONF),
                                   reps=10),
                predict_ms=cuda_ms(lambda: det.predict(images, conf_thres=CONF), reps=10))


def sp_planted(torch, det, images, mesh, kinds) -> dict:
    """The layer check's teeth, in every e2e_sp run: each halo fault of
    ``kinds`` (sp_fault) planted on ``mesh`` must read above SP_LAYER_REL
    and change at least one exchange."""
    with torch.no_grad():
        want = det.predict(images, conf_thres=CONF)
    runs = {kind: sp_faulty_run(torch, det, images, mesh, kind, want, layers=True)
            for kind in kinds}
    caught = {k: bool(r["changed"]) and r["layer_rel"] > SP_LAYER_REL for k, r in runs.items()}
    return dict(runs=runs, caught=caught, ok=all(caught.values()))


def sp_cudnn_modes(torch):
    """cuDNN settings under which sp_spread also reads f32 sp 2 at batch 1
    (both sides under the setting): name -> context manager."""
    def flags(**kw):
        @contextlib.contextmanager
        def cm():
            keep = {k: getattr(torch.backends.cudnn, k) for k in kw}
            for k, v in kw.items():
                setattr(torch.backends.cudnn, k, v)
            try:
                yield
            finally:
                for k, v in keep.items():
                    setattr(torch.backends.cudnn, k, v)
        return cm
    return {"cudnn_benchmark": flags(benchmark=True),
            "cudnn_deterministic": flags(deterministic=True),
            "cudnn_off": flags(enabled=False)}


def sp_spread(torch, n_seeds: int) -> None:
    """The readings SP_LAYER_REL, SP_F32_LIMITS and SP_BF16_LIMITS stand
    on: yolov8l seeded with SEED + s for ``n_seeds`` seeds, BatchNorm
    calibrated and head spread on its own batch, sp 2 and sp 4 at batch 1
    and sp 2 at batch 8, in f32 and bf16; the families at sp 2, batch 1,
    f32 (seeded model_seed + s); each against Detector.predict, sound (and
    whether the sharded run's convolutions are predict's, conv_kernels)
    and with each of SP_FAULTS planted; f32 layer by layer too
    (sp_layer_spread). yolov8l's f32 sp 2 at batch 1 is also read under
    other cuDNN settings (sp_cudnn_modes; ints_equal). One line a reading,
    then per model and dtype the worst sound reading and the least faulty
    one per fault. Asserts nothing."""
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.parallel import make_mesh, spatial

    (flags,), = spatial.run([(spatial.SpGroup(card0(1)), lambda _: (
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32), [None], [0])])
    emit("sp_thread_flags", cudnn_allow_tf32=flags[0], matmul_allow_tf32=flags[1])
    worst, least = {}, {}

    def note(acc, pick, key, r):
        slot = acc.setdefault(key, {})
        for k, v in r.items():
            if isinstance(v, float):
                slot[k] = pick(slot.get(k, v), v)

    def read(d, name, key, sp, batch, x, s):
        mesh = make_mesh(sp=sp, devices=card0(sp))
        with torch.no_grad():
            want = d.predict(x, conf_thres=CONF)
            got = d.predict_sharded(x, mesh, conf_thres=CONF)
        only = conv_kernels(torch, lambda: d.predict_sharded(x, mesh, conf_thres=CONF)) \
            - conv_kernels(torch, lambda: d.predict(x, conf_thres=CONF))
        r = sp_spread_of(torch, got, want)
        if key == "f32":
            lay = sp_layer_spread(torch, d, x, mesh)
            r.update(layer_worst=lay["worst_layer"], layer_rel=lay["worst_rel"])
        emit("sp_reading", model=name, seed=s, dtype=key, sp=sp, batch=batch, mode="sound",
             same_algorithms=not only, sharded_only_kernels=sorted(k[:80] for k in only), **r)
        note(worst, max, f"{name}_{key}", r)
        for kind in SP_FAULTS:
            r = sp_faulty_run(torch, d, x, mesh, kind, want, layers=key == "f32")
            emit("sp_reading", model=name, seed=s, dtype=key, sp=sp, batch=batch, mode=kind,
                 **r)
            if r["changed"]:
                note(least, min, f"{name}_{key}_{kind}", r)
        if name == MODEL and key == "f32" and (sp, batch) == (2, 1):
            for mode, cm in sp_cudnn_modes(torch).items():
                with cm(), torch.no_grad():
                    want = d.predict(x, conf_thres=CONF)
                    got = d.predict_sharded(x, mesh, conf_thres=CONF)
                    ints = all(torch.equal(getattr(got.det, f), getattr(want.det, f))
                               for f in ("valid", "cls", "anchor_idx"))
                emit("sp_reading", model=name, seed=s, dtype=key, sp=sp, batch=batch,
                     mode=mode, ints_equal=ints, **sp_spread_of(torch, got, want))

    for s in range(n_seeds):
        images = make_batches(np.random.default_rng(SEED + 40 + s), 1)[0]
        det = family_detector(torch, MODEL, [images], seed=SEED + s)
        det16 = Detector.create(MODEL, nc=NC, img_size=IMG, device=DEVICE, dtype=torch.bfloat16,
                                state_dict=det.model.state_dict())
        for d, key in ((det, "f32"), (det16, "bf16")):
            for sp, batch in ((2, 1), (4, 1), (2, BATCH)):
                read(d, MODEL, key, sp, batch, images[:batch], s)
        del det, det16
        for name in FAMILIES:
            fdet = family_detector(torch, name, [images], seed=model_seed(name) + s)
            read(fdet, name, "f32", 2, 1, images[:1], s)
            del fdet
        torch.cuda.empty_cache()
    emit("sp_spread", seeds=n_seeds, layer_limit=SP_LAYER_REL, f32_limits=SP_F32_LIMITS,
         bf16_limits=SP_BF16_LIMITS, worst_sound=worst, least_faulty=least)


def sp_slab_case(torch, det, images) -> dict:
    """K4 on the halo slab of sp 2's second shard (image rows [IMG/2 - 4,
    IMG) of one image, STEM_OVERLAP rows above its own) against its plain
    version on the same slab, in f32 and bf16 (STEM_TOL), and its rows
    past the first against the unsharded K4's rows of that shard (the same
    limits); the slab's times (stem_timings)."""
    from ood_in_object_detection_torch.ops import stem as S
    from ood_in_object_detection_torch.parallel.spatial import STEM_OVERLAP

    x = torch.from_numpy(images[:1]).to(DEVICE).permute(0, 3, 1, 2).float() * (1 / 255)
    lo = IMG // 2 - STEM_OVERLAP
    slab = x[:, :, lo:].contiguous()
    m0, m1 = det.model.model[0], det.model.model[1]
    params = S.stem_conv_params(m0, m1)
    out, failures = dict(case="sp_slab", shape=list(slab.shape), rows=[lo, IMG]), []
    for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        with torch.no_grad():
            got = S.fused_stem(slab, m0, m1, dt).float()
            ref = S.fused_stem_plain(slab, *params, dt).float()
            whole = S.fused_stem(x.contiguous(), m0, m1, dt).float()[:, :, IMG // 8:]
        rel = float((got - ref).abs().max() / ref.abs().max())
        kept = float((got[:, :, STEM_OVERLAP // 4:] - whole).abs().max() / whole.abs().max())
        out[key] = dict(rel_err=rel, max_abs_err=float((got - ref).abs().max()),
                        kept_rows_rel_err=kept)
        emit("kernel_case", kernel="fused_stem", case="sp_slab", dtype=key,
             shape=list(slab.shape), rel_err=rel, kept_rows_rel_err=kept)
        if rel > STEM_TOL[key] or kept > STEM_TOL[key]:
            failures.append(f"K4 on the sp slab {key}: rel err {rel}, kept rows {kept} > "
                            f"{STEM_TOL[key]}")
    out.update(stem_timings(torch, S, m0, m1, slab, torch.float32))
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def sp_server_check(torch, det, images, mesh) -> dict:
    """MicroBatchServer(mesh=) over ``mesh``: SP_SERVE_REQUESTS requests
    queued from one thread (a 2 s wait fills each group), the counters reset
    around them; each result equal, bit for bit, to its row of a direct
    predict_sharded of its group as the server stacked it (sp_predict_check
    holds predict_sharded against Detector.predict)."""
    from ood_in_object_detection_torch.serving import MicroBatchServer

    views = [images[k % len(images)].copy() for k in range(SP_SERVE_REQUESTS)]
    index = {id(v): k for k, v in enumerate(views)}
    groups = []
    srv = MicroBatchServer(det, batch_size=BATCH, max_wait_ms=2000.0, conf_thres=CONF, mesh=mesh)
    collect = srv._collect

    def recording_collect():
        group = collect()
        if group is not None:
            groups.append([index[id(r.image)] for r in group])
        return group

    srv._collect = recording_collect
    srv.start()
    try:
        reset_counters()
        t0 = time.perf_counter()
        futs = [srv.submit(v) for v in views]
        results = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        launches = read_counters()
    finally:
        srv.stop()
    bad = 0
    for rows in groups:
        batch = np.zeros((BATCH, IMG, IMG, 3), np.uint8)
        batch[:len(rows)] = np.stack([views[k] for k in rows])
        with torch.no_grad():
            direct = det.predict_sharded(batch, mesh, conf_thres=CONF)
        for j, k in enumerate(rows):
            v = direct.det.valid[j]
            r = results[k]
            bad += not (r["num_valid"] == int(v.sum())
                        and np.array_equal(r["boxes"], direct.det.boxes[j][v].cpu().numpy())
                        and np.array_equal(r["conf"], direct.det.conf[j][v].cpu().numpy())
                        and np.array_equal(r["cls"], direct.det.cls[j][v].cpu().numpy())
                        and np.array_equal(r["logits"], direct.logits[j][v].cpu().numpy()))
    return dict(requests=SP_SERVE_REQUESTS, groups=[len(g) for g in groups], mismatches=bad,
                wall_s=wall, images_per_s=SP_SERVE_REQUESTS / wall,
                launches={k: launches[k] for k in SP_KERNELS},
                ok=bool(bad == 0 and all(launches[k] for k in SP_KERNELS)))


def phase_e2e_sp(torch, det, det16, images, env) -> tuple:
    """Spatial parallelism on e2e's yolov8l (f32, TF32 off) and its bf16
    twin: predict_sharded on sp 2 and sp 4 at batch 1 and data 2 x sp 2 at
    batch 8 (the card named as often as the mesh has entries; every card in
    one sp mesh where more than one is visible) against Detector.predict
    (sp_predict_check: f32 layer by layer and end to end), sp 2 at batch 8
    in bf16 within SP_BF16_LIMITS, two halo faults planted at sp 2 that the
    layer check must catch (sp_planted), K4 on a halo slab (sp_slab_case),
    MicroBatchServer(mesh=sp 2)
    (sp_server_check), and yolov9c, yolov10l, yolo11l and yolo12l at sp 2,
    batch 1. -> (the launches of the phase's sharded runs, the slab case)."""
    from ood_in_object_detection_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    failures, launches, checks = [], [], {}
    n_cards = torch.cuda.device_count()
    meshes = [("sp2", make_mesh(sp=2, devices=card0(2)), 1),
              ("sp4", make_mesh(sp=4, devices=card0(4)), 1),
              ("data2_sp2", make_mesh(data=2, sp=2, devices=card0(4)), BATCH)]
    for key, mesh, batch in meshes:
        r = checks[key] = sp_predict_check(torch, det, images[:batch], mesh)
        launches.append(r["launches"])
        if not r["ok"]:
            failures.append(f"predict_sharded {key}: {r}")
    r = checks["sp2_bf16"] = sp_predict_check(torch, det16, images, meshes[0][1])
    launches.append(r["launches"])
    if not r["ok"]:
        failures.append(f"predict_sharded sp2 bf16: {r}")
    if n_cards > 1:
        r = checks["all_cards"] = sp_predict_check(torch, det, images[:1],
                                                   make_mesh(sp=n_cards))
        launches.append(r["launches"])
        if not r["ok"]:
            failures.append(f"predict_sharded over every card: {r}")
    else:
        checks["all_cards"] = "not run: one card is visible"
    planted = checks["planted"] = sp_planted(torch, det, images[:1], meshes[0][1],
                                             ("window_shift", "pool_no_halo"))
    if not planted["ok"]:
        failures.append(f"the layer check missed a planted halo fault: {planted}")
    slab = sp_slab_case(torch, det, images)
    server = sp_server_check(torch, det, images, meshes[0][1])
    launches.append(server["launches"])
    if not server["ok"]:
        failures.append(f"server over sp 2: {server}")
    families = {}
    for name in FAMILIES:
        fdet = family_detector(torch, name, [images])
        r = families[name] = sp_predict_check(torch, fdet, images[:1], meshes[0][1], name)
        launches.append(r["launches"])
        if not r["ok"]:
            failures.append(f"predict_sharded sp2 {name}: {r}")
        del fdet
        torch.cuda.empty_cache()
    emit("e2e_sp", model=MODEL, img_size=IMG, nc=NC, cards=n_cards, card=env["nvidia_smi"],
         checks=checks, server=server, families=families,
         dp_predict_limits=DP_PREDICT_LIMITS, layer_limit=SP_LAYER_REL, limits_f32=SP_F32_LIMITS, limits_bf16=SP_BF16_LIMITS,
         k4_slab={k: slab[k] for k in ("shape", "f32", "bf16")},
         phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_sp: " + "; ".join(failures))
    full = {k: 0 for k in read_counters()}
    return _added(full, *[{**full, **c} for c in launches]), slab


# spatial and tensor parallelism in training (e2e_sp_train): the batch-16
# step on gloo worlds of card 0 named 2 or 4 times, against e2e_dp's
# single-process step (DP_TRAIN_LIMITS). One spawn a world size: e2e_dp's
# data 2 world of card 0 named twice, sp 2 and model 2 share the two ranks
# of one process group (starting the ranks took 20-42 s a spawn on the
# card's host, PERF.md section 6). Planted faults: no_halo_grad and
# loss_gather_summed at sp 2, no_tp_input_reduce at model 2 (train_fault).
# Timed steps after the checked ones (model 2's first step stands for its
# own: a step takes ~15 s there, its channel slices staged through the host)
SP_TRAIN_SPAWNS = (
    (("data2", dict(axes=dict(data=2), timed=2)),
     ("sp2", dict(axes=dict(sp=2), timed=1, remat=True,
                  faults=("no_halo_grad", "loss_gather_summed"))),
     ("model2", dict(axes=dict(model=2), faults=("no_tp_input_reduce",)))),
    (("data2_sp2", dict(axes=dict(data=2, sp=2), timed=1)),))


def phase_e2e_sp_train(torch, env, ref_path=None) -> None:
    """Spatial and tensor parallelism in training: the batch-16 step of
    yolov8l at 640 px (nc 20, TF32 off, seeded) on the gloo worlds of
    card 0 named 2 or 4 times (SP_TRAIN_SPAWNS: e2e_dp's data 2, sp 2 and
    model 2 on one pair of ranks, data 2 x sp 2 on four), each against the
    single-process step on the same global batch (e2e_dp's, saved at
    ``ref_path``, or taken here) within DP_TRAIN_LIMITS, with its planted
    faults (train_run); one line a world, then the phase's line. A spawn
    that fails, or a world whose check fails, fails the phase."""
    import tempfile
    from pathlib import Path

    t_phase = time.perf_counter()
    failures, worlds = [], {}
    card = 0 if DEVICE == "cuda" else DEVICE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_train_") as tmp:
        if ref_path is None:
            ref_path = Path(tmp) / "ref.pt"
            model, _, _ = dp_single_ref(torch, overfit_batch(TRAIN_BATCH), ref_path)
            del model
        torch.cuda.empty_cache()
        for spawn_worlds in SP_TRAIN_SPAWNS:
            spec = [TrainWorld(key, ref=str(ref_path), **kw) for key, kw in spawn_worlds]
            devices = [card] * int(np.prod(list(spec[0].axes.values())))
            try:
                runs = train_run(torch, devices, spec, TRAIN_BATCH)
            except Exception as e:  # noqa: BLE001 (a spawn that fails fails the phase)
                failures.append(f"{[w.key for w in spec]}: {e}")
                continue
            for key, r in runs.items():
                worlds[key] = r
                emit("e2e_sp_train_world", card=env["nvidia_smi"], **r)
                if not r["ok"]:
                    failures.append(f"{key}: {r}")
    emit("e2e_sp_train", model=MODEL, img_size=IMG, nc=NC, train_batch=TRAIN_BATCH,
         card=env["nvidia_smi"], limits=DP_TRAIN_LIMITS, fault_factor=TRAIN_FAULT_FACTOR,
         worlds={k: {f: v[f] for f in ("ok", "first_step_ms", "step_ms", "loss_rel",
                                       "update_rel", "seconds")}
                 for k, v in worlds.items()},
         phase_seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError("e2e_sp_train: " + "; ".join(failures))


def phase_xscale_stem(torch, images) -> list:
    """K4's second specialization (C1 96, C2 192) on yolo11x's stem: the
    model seeded, BatchNorm calibrated on ``images`` and head spread, its
    predict step (the serving path's device step) in f32 and bf16 with the
    counters reset just before and read just after; K4 must launch. Then K4
    against its plain version on that stem and images, as kernel entries
    tagged with the model."""
    from ood_in_object_detection_torch.engine import Detector

    name = "yolo11x"
    det = family_detector(torch, name, [images], seed=SEED + 40)
    if det.model.stem_route != "fused" or det.model.stem_widths != (96, 192):
        raise AssertionError(f"{name}: stem route {det.model.stem_route}, widths "
                             f"{det.model.stem_widths}")
    det16 = Detector.create(name, nc=NC, img_size=IMG, device=DEVICE, dtype=torch.bfloat16)
    det16.model.load_state_dict(det.model.state_dict())
    entries, lines = [], {}
    for d, dt, key in ((det, torch.float32, "f32"), (det16, torch.bfloat16, "bf16")):
        reset_counters()
        out = d.predict(images, conf_thres=CONF)
        torch.cuda.synchronize()
        launches = read_counters()
        if launches["fused_stem"] != 1:
            raise AssertionError(f"{name} {key}: K4 did not launch once a step: {launches}")
        for t in (out.det.boxes, out.det.conf, out.logits, out.roi_feats.float()):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name} {key}: non-finite predict output")
        lines[key] = dict(launches=launches,
                          predict_step_ms=cuda_ms(lambda: d.predict(images, conf_thres=CONF),
                                                  reps=5),
                          detections_per_image=float(out.det.valid.sum(1).float().mean()))
        with torch.no_grad():
            entries.append(family_stem_entry(torch, d, images, launches["fused_stem"], name, dt))
    emit("e2e_xscale", model=name, stem_route=det.model.stem_route,
         stem_widths=list(det.model.stem_widths),
         params=sum(p.numel() for p in det.model.parameters()), **lines)
    del det, det16
    torch.cuda.empty_cache()
    return entries


def flip_shares(det32, det16, methods32, methods16, ood):
    """Share of detections (image, anchor) found by one precision only, and
    of per-box decisions that differ on the detections both found."""
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method

    neck = det32.neck_channels()
    det_diff = det_all = dec_diff = dec_all = 0
    for batch in ood:
        o32 = det32.predict(batch["images"], conf_thres=CONF)
        o16 = det16.predict(batch["images"], conf_thres=CONF)
        dec = {name: (_decisions_for_method(methods32[name], o32, neck).cpu().numpy(),
                      _decisions_for_method(methods16[name], o16, neck).cpu().numpy())
               for name in methods32}
        for i in range(len(batch["images"])):
            rows = []
            for o in (o32, o16):
                valid = o.det.valid[i].cpu().numpy()
                rows.append({int(a): j for j, a in enumerate(o.anchor_idx[i].cpu().numpy())
                             if valid[j]})
            common = rows[0].keys() & rows[1].keys()
            det_diff += len(rows[0].keys() ^ rows[1].keys())
            det_all += len(rows[0].keys() | rows[1].keys())
            for d32, d16 in dec.values():
                dec_diff += sum(d32[i, rows[0][a]] != d16[i, rows[1][a]] for a in common)
                dec_all += len(common)
    return det_diff / max(det_all, 1), dec_diff / max(dec_all, 1), det_all, dec_all


def phase_e2e_bf16(torch, det32, methods32, ind, ood):
    """The --bf16 path: f32 parameters, bf16 compute and taps, the f32
    path's weights and ground truth."""
    from ood_in_object_detection_torch.engine import Detector

    det = Detector.create(MODEL, nc=NC, img_size=IMG, device=DEVICE, dtype=torch.bfloat16)
    det.model.load_state_dict(det32.model.state_dict())
    reset_counters()
    t0 = time.perf_counter()
    methods, results, n_clusters = run_methods(det, ind, ood)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    if not (launches["fused_stem"] and launches["roi_contract_bf16"]) or launches["roi_contract"]:
        raise AssertionError(f"the bf16 path did not launch K4 and K2's bf16 route: {launches}")

    images = ood[0]["images"]
    out = det.predict(images, conf_thres=CONF)
    if not all(f.dtype == torch.bfloat16 for f in out.neck) or out.roi_feats.dtype != torch.bfloat16:
        raise AssertionError("the bf16 path's taps are not bf16")
    for t in (out.det.boxes, out.det.conf, out.logits, out.roi_feats.float(), out.exact_feats.float()):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite bf16 predict output")
    step_ms = cuda_ms(lambda: det.predict(images, conf_thres=CONF), reps=10)
    det_share, dec_share, n_det, n_dec = flip_shares(det32, det, methods32, methods, ood)
    emit("e2e_bf16", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, dtype="bfloat16",
         seconds=seconds, launches=launches, metrics=results, clusters=n_clusters,
         thresholds={k: m.thresholds for k, m in methods.items()},
         detections_per_image=float(out.det.valid.sum(1).float().mean()),
         predict_step_ms=step_ms, images_per_s=BATCH * 1000.0 / step_ms,
         predict_step_ms_unfused_stem=unfused_stem_ms(det, images),
         detections_differing_from_f32=det_share, detections_compared=n_det,
         decisions_differing_from_f32=dec_share, decisions_compared=n_dec,
         ceilings=dict(detections=DET_FLIP_CEIL, decisions=DECISION_FLIP_CEIL))
    if det_share > DET_FLIP_CEIL or dec_share > DECISION_FLIP_CEIL:
        raise AssertionError(f"bf16 differs from f32 on {det_share:.3f} of detections and "
                             f"{dec_share:.3f} of decisions (ceilings {DET_FLIP_CEIL}, "
                             f"{DECISION_FLIP_CEIL})")
    return det, launches, step_ms


# card against CPU on one image, end to end: raw maps (of their largest
# magnitude), the share of the CPU's detections the card also makes, the
# matched boxes (px), RoI and exact taps (of their scale). cuDNN's f32
# convolution algorithms and the CPU sum in other orders, a deeper random
# network amplifies that layer after layer, and a detection near a
# threshold may cross it; a box edge that moved also moves its RoI window,
# so RoI features get more room than the exact (anchor-cell) tap.
# class_flip_at_tie: a detection's class may differ where the CPU's two
# best logits sit within twice the largest raw-map difference. yolov8l's
# limits date from the port's first card runs; yolov9c, yolo11l and
# yolo12l take them too. The worst sound readings of these four models over
# 4 seeds (``python3 chip_smoke.py --reference-seeds 4`` on an H100,
# PERF.md section 5): maps 2.1e-4, boxes 0.27 px, overlap
# 0.9967, RoI 2.2e-3, exact 1.8e-4. yolov10l amplifies the same per-layer
# differences most (worst maps 2.4e-3, boxes 1.41 px, RoI 3.9e-3, exact
# 1.3e-3), so its limits stand 3.5-5x above those. A fault of 1e-3 at the
# stem's output gave at least 6.5e-2 of the map and 3.6 px on every model.
# Every model is also held layer by layer: each layer on the card against
# the same layer on the CPU, on the CPU's own input to it (nothing
# accumulates), the stem both as its two Conv modules and through
# fused_stem (K4 on the card), within LAYER_REL_TOL of the layer's largest
# magnitude (worst sound reading 4.9e-6; the fault above, 1.8e-3).
_V8L_LIMITS = dict(raw_map_rel_err=1e-3, overlap=0.98, box_abs_err_px=1.0, roi_feat_rel_err=1e-2,
                   exact_feat_rel_err=1e-3)
REF_LIMITS = {
    "yolov8l": dict(_V8L_LIMITS, class_flip_at_tie=False),
    "yolov9c": dict(_V8L_LIMITS, class_flip_at_tie=True),
    "yolov10l": dict(raw_map_rel_err=1e-2, overlap=0.98, box_abs_err_px=5.0,
                     roi_feat_rel_err=2e-2, exact_feat_rel_err=5e-3, class_flip_at_tie=True,
                     why="a random yolov10l amplifies per-layer differences of <= 3.5e-6 to "
                         "2.4e-3 of the map and 1.41 px over 4 seeds; these limits stand "
                         "3.5-5x above its worst sound readings"),
    "yolo11l": dict(_V8L_LIMITS, class_flip_at_tie=True),
    "yolo12l": dict(_V8L_LIMITS, class_flip_at_tie=True),
}
LAYER_REL_TOL = 1e-4
# the fault of the readings: the card's stem output scaled by 1 + STEM_FAULT
STEM_FAULT = 1e-3


def _flat_tensors(out):
    """The tensors of a layer's output (a tensor, or nested lists/tuples)."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat_tensors(o)]
    return [out]


def _rel_err(gpu_out, cpu_out) -> float:
    """max |card - CPU| / max |CPU| over the tensors of one output."""
    return max([float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
                for g, c in zip(_flat_tensors(gpu_out), _flat_tensors(cpu_out))] + [0.0])


def layer_errors(torch, gpu_model, cpu_model, x) -> dict:
    """Each layer of the card's model run on the CPU model's own input to
    that layer (the stem as its two Conv modules on both, and, on the fused
    route, through fused_stem: K4 on the card) -> {"<i>_<module>": max
    |card - CPU| / max |CPU|}."""
    from ood_in_object_detection_torch.ops.stem import fused_stem

    def to_dev(v):
        return [to_dev(t) for t in v] if isinstance(v, (list, tuple)) else v.to(DEVICE)

    ys, errs = [], {}
    if gpu_model.stem_route == "fused":
        dt = cpu_model.compute_dtype
        errs["0-1_fused_stem"] = _rel_err(fused_stem(x.to(DEVICE), *gpu_model.model[:2], dt),
                                          fused_stem(x, *cpu_model.model[:2], dt))
    for li, ((frm, _, mod, _), mg, mc) in enumerate(zip(cpu_model.spec, gpu_model.model,
                                                        cpu_model.model)):
        if li == 0:
            inp = x
        elif isinstance(frm, int):
            inp = ys[-1] if frm == -1 else ys[frm]
        else:
            inp = [ys[-1] if i == -1 else ys[i] for i in frm]
        out_c = mc(inp)
        errs[f"{li}_{mod}"] = _rel_err(mg(to_dev(inp)), out_c)
        ys.append(out_c)
    return errs


def reference_reading(torch, det, images, fault: float = 0.0) -> dict:
    """The first of ``images`` through the card's kernel path and the CPU's
    plain path with the same weights -> the end-to-end errors (REF_LIMITS'
    keys), the class flips with the CPU's margin between its two best
    logits, and every layer's error (layer_errors). ``fault``: the card's
    stem output scaled by 1 + fault (a forward pre-hook on layer 2)."""
    import copy

    from ood_in_object_detection_torch.engine import Detector

    cpu = Detector(model=copy.deepcopy(det.model).cpu(), img_size=det.img_size)
    hook = det.model.model[2].register_forward_pre_hook(
        lambda _, args: tuple(a * (1.0 + fault) for a in args)) if fault else None
    try:
        img = images[:1]
        g, c = det.predict(img, conf_thres=CONF), cpu.predict(img, conf_thres=CONF)
        with torch.no_grad():
            x = torch.from_numpy(img).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
            raw_g = det.model(x.to(DEVICE))[0]
            raw_c = cpu.model(x)[0]
            layers = layer_errors(torch, det.model, cpu.model, x)
    finally:
        if hook is not None:
            hook.remove()
    map_err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(raw_g, raw_c))
    raw_abs_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(raw_g, raw_c))
    r = detection_errors(torch, g, c, 0, raw_abs_err)
    r["errors"] = dict(raw_map_rel_err=map_err, **r["errors"])
    return dict(r, raw_map_abs_err=raw_abs_err, layers=layers)


def within_ref_limits(r, limits) -> bool:
    """A reading (``detection_errors`` with its raw map error) within a row
    of REF_LIMITS: classes equal, or flipped at ties only where the row
    allows it; the overlap above its floor, every error below its limit."""
    got = r["errors"]
    return (r["cls_equal"] or (limits["class_flip_at_tie"] and r["ties_only"])) \
        and got["overlap"] > limits["overlap"] \
        and all(got[k] < limits[k] for k in got if k != "overlap")


def detection_errors(torch, g, c, i, raw_abs_err) -> dict:
    """Image ``i`` of the card's PredictOutput ``g`` against the CPU's
    ``c``, detections matched by anchor: the detection counts, the class
    flips with the CPU's margin between its two best logits (ties_only: each
    within twice ``raw_abs_err``, the raw maps' largest difference) and the
    errors of REF_LIMITS but the raw map's."""
    ga, ca = g.anchor_idx[i][g.det.valid[i]].cpu(), c.anchor_idx[i][c.det.valid[i]]
    common = np.intersect1d(ga.numpy(), ca.numpy())
    if len(common) == 0:
        raise AssertionError(f"card and CPU share no detection on image {i}")
    gi = {int(a): k for k, a in enumerate(ga)}
    ci = {int(a): k for k, a in enumerate(ca)}
    rows_g = torch.tensor([gi[int(a)] for a in common])
    rows_c = torch.tensor([ci[int(a)] for a in common])
    box_err = float((g.det.boxes[i, rows_g].cpu() - c.det.boxes[i, rows_c]).abs().max())
    flipped = g.det.cls[i, rows_g].cpu() != c.det.cls[i, rows_c]
    top2 = c.logits[i, rows_c][flipped].topk(2, dim=-1).values
    flip_margins = (top2[:, 0] - top2[:, 1]).tolist()
    roi_err, exact_err = (float((a[i, rows_g].cpu() - b[i, rows_c]).abs().max()
                                / b[i].abs().max())
                          for a, b in ((g.roi_feats, c.roi_feats), (g.exact_feats, c.exact_feats)))
    return dict(detections_card=len(ga), detections_cpu=len(ca),
                cls_equal=not bool(flipped.any()), class_flip_margins=flip_margins,
                ties_only=all(m <= 2 * raw_abs_err for m in flip_margins),
                errors=dict(overlap=len(common) / len(ca), box_abs_err_px=box_err,
                            roi_feat_rel_err=roi_err, exact_feat_rel_err=exact_err))


def phase_reference(torch, det, images, label="reference", model=MODEL):
    """The card's kernel path against the CPU's plain path on one image,
    end to end within REF_LIMITS[model] and layer by layer within
    LAYER_REL_TOL."""
    r = reference_reading(torch, det, images)
    limits, got = REF_LIMITS[model], r["errors"]
    worst = sorted(r["layers"].items(), key=lambda kv: -kv[1])[:5]
    emit(label, model=model, **{k: v for k, v in r.items() if k not in ("errors", "layers")},
         **got, limits=limits, layer_rel_err_worst=dict(worst), layer_rel_tol=LAYER_REL_TOL)
    if not within_ref_limits(r, limits) or any(e > LAYER_REL_TOL for e in r["layers"].values()):
        raise AssertionError(f"{model}: card and CPU disagree on the reference image")


def sdr_spread(torch, det, seed, worst) -> None:
    """The readings SDR_DIST_REL_LIMITS stand on, for one seed: the four SDR
    methods fitted on the card on SWEEP_BATCHES labelled batches of seeded
    scenes (seed 0: e2e_sdr's), then sdr_reading on one more, sound and with
    a fault of STEM_FAULT in the card's embedders' first layer, and
    sdr_fit_quality, sound and with each of SDR_FIT_FAULTS that applies;
    one line a reading, the worst per method and fault into ``worst``."""
    from ood_in_object_detection_torch.cli.factory import build_ood_method
    from ood_in_object_detection_torch.ood.methods import FusionOODMethod
    from ood_in_object_detection_torch.ood.pipeline import extract_ind_activations, fit_ind_pipeline

    rng = np.random.default_rng(SEED + 20 + 1000 * seed)  # e2e_sweeps' scenes at seed 0
    ind = label_batches(det, make_scenes(rng, SWEEP_BATCHES))
    ood = label_batches(det, make_scenes(rng, 1), unknown_every=3)
    methods = {n: build_ood_method(n, device=det.device) for n in SDR_RUN}
    acts = extract_ind_activations(det, ind, FusionOODMethod(list(methods.values())),
                                   conf_thr_train=CONF)
    out = det.predict(ood[0]["images"], conf_thres=CONF)
    for name, m in methods.items():
        fit_ind_pipeline(m, acts, tpr=0.95)
        for fault in (0.0, STEM_FAULT):
            r = sdr_reading(torch, m, out, det.neck_channels(), fault=fault)
            emit("sdr_reading", method=name, seed=seed, fault=fault, **r)
            w = worst.setdefault(f"sdr {name} fault {fault}", dict(dist_rel_err=0.0))
            w["dist_rel_err"] = max(w["dist_rel_err"], r["dist_rel_err"])
            w["decisions_equal"] = w.get("decisions_equal", True) and r["decisions_equal"]
        cpu_fits = {}
        for fault in (None,) + SDR_FIT_FAULTS:
            if fault == "shuffled_labels" and m.sdr_state["kind"] != "ivis":
                continue
            r = sdr_fit_quality(torch, m, acts[id(m)], fault=fault, cpu_fits=cpu_fits)
            emit("sdr_fit_quality", method=name, seed=seed, **r)
            w = worst.setdefault(f"sdr fit {name} fault {fault}", dict(caught=0, readings=0))
            w["caught"] += bool(r["failures"])
            w["readings"] += 1


def reference_spread(torch, n_seeds: int) -> None:
    """The readings REF_LIMITS stand on: yolov8l and each family on
    ``n_seeds`` seeds of weights and images (seed 0 is the main run's),
    each sound and with a fault of STEM_FAULT at the card's stem output;
    and, on yolov8l, those of SDR_DIST_REL_LIMITS (sdr_spread); one line a
    reading, then each model's worst per error. Asserts nothing."""
    worst = {}
    for name in (MODEL,) + FAMILIES:
        for s in range(n_seeds):
            rng = np.random.default_rng(SEED + (0 if name == MODEL else 10) + 1000 * s)
            images = make_batches(rng, 3)  # main run: 2 InD batches, then the OoD batch
            det = family_detector(torch, name, images, seed=model_seed(name) + 1000 * s)
            if name == MODEL:
                sdr_spread(torch, det, s, worst)
            for fault in (0.0, STEM_FAULT):
                r = reference_reading(torch, det, images[2], fault=fault)
                layer = sorted(r["layers"].items(), key=lambda kv: -kv[1])[:3]
                emit("reference_reading", model=name, seed=s, fault=fault,
                     **{k: v for k, v in r.items() if k not in ("errors", "layers")},
                     **r["errors"], layer_rel_err_worst=dict(layer))
                w = worst.setdefault(f"{name} fault {fault}", dict(overlap=1.0, class_flips=0))
                for k, v in r["errors"].items():
                    w[k] = min(w[k], v) if k == "overlap" else max(w.get(k, 0.0), v)
                w["layer_rel_err"] = max(w.get("layer_rel_err", 0.0), layer[0][1])
                w["class_flips"] += len(r["class_flip_margins"])
            del det
            torch.cuda.empty_cache()
    emit("reference_spread", seeds=n_seeds, stem_fault=STEM_FAULT, worst=worst)


def profile_rows(torch, fn, steps: int = 3):
    """torch.profiler over ``steps`` calls of ``fn`` -> (device rows, host
    rows), each (us per call, name, calls per call), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / steps, e.key, e.count / steps)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    host = sorted(((e.self_cpu_time_total / steps, e.key, e.count / steps)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0), reverse=True)
    return rows, host


def phase_profile(torch, det, images, step_ms: float, steps: int = 3, label="profile"):
    """Device time of the predict step by kernel (torch.profiler / CUPTI),
    and its share of the step's CUDA-event time."""
    rows, host = profile_rows(torch, lambda: det.predict(images, conf_thres=CONF), steps)
    device_us = sum(r[0] for r in rows)
    emit(label, steps=steps, kernels_per_step=sum(r[2] for r in rows),
         device_us_per_step=device_us if rows else "not measured",
         device_busy_share=device_us / (step_ms * 1000.0) if rows else "not measured",
         top=[{"name": k[:90], "us_per_step": t, "calls_per_step": c} for t, k, c in rows[:15]],
         host_top=[{"name": k[:60], "host_us_per_step": t, "calls_per_step": c}
                   for t, k, c in host[:12]])


def support_cells(torch, wx, wy):
    """Cells of each row's support rectangle (0 for an all-zero row): what
    K2 reads for these rows, (B, N2) float64."""
    def span(v):
        idx = torch.arange(v.shape[-1], device=v.device)
        lo = torch.where(v != 0, idx, v.shape[-1]).amin(-1)
        hi = torch.where(v != 0, idx, -1).amax(-1)
        return (hi - lo + 1).clamp(min=0).double()

    return span(wx) * span(wy)


def roi_entry(torch, R, name, replaces, out, launches, tol, model=MODEL):
    """K2 on every level's map with the real RoI + exact-tap axis weights of
    ``out``; against the plain version, torch.bmm of a materialised Q, and
    building Q from wx and wy plus torch.bmm; the wrapper's time (``ms``,
    three levels, host included) and its device time (``device_ms``, CUDA
    events around calls queued behind a spinning kernel, bench_k3.queued_ms).
    Per level, the count of non-empty rows and their
    support rectangles (cells)."""
    level_args, err, off, moved, ops, qs = [], 0.0, 0, 0, 0.0, []
    kind = "bf16" if out.neck[0].dtype == torch.bfloat16 else "f32"
    for f in out.neck:
        b, h, w, c = f.shape
        wx, wy = R.level_axis_weights((h, w), out.det.boxes, out.anchor_idx, out.stride_level,
                                      len(level_args), off, IMG, 0)
        off += h * w
        got, ref = R.roi_contract(f, wx, wy), R.roi_contract_plain(f, wx, wy)
        e = float((got - ref).abs().max() / ref.abs().max())
        err = max(err, float((got - ref).abs().max()))
        cells = support_cells(torch, wx, wy)
        used = cells[cells > 0]
        onehot = (wx.amax(-1) == 1.0) & (wy.amax(-1) == 1.0)
        onehot_exact = bool(torch.equal(got[onehot], ref[onehot]))
        emit("kernel_case", kernel=name, model=model, case=f"level_{h}x{w}",
             shape=list(f.shape), dtype=kind, rows=wx.shape[1] * b, nonempty_rows=int(used.numel()),
             onehot_rows=int(onehot.sum()), onehot_bit_exact=onehot_exact,
             support_cells=dict(median=float(used.median()) if used.numel() else 0.0,
                                p99=float(used.quantile(0.99)) if used.numel() else 0.0,
                                max=float(used.max()) if used.numel() else 0.0,
                                total=float(used.sum())),
             rel_err=e)
        if e > tol or (kind == "bf16" and not onehot_exact):
            raise AssertionError(f"{name} level {h}x{w}: rel err {e} > {tol} or one-hot rows "
                                 f"not bit-exact ({onehot_exact})")
        level_args.append((f, wx, wy))
        moved += nbytes(f, wx, wy, got)
        ops += float(cells.sum()) * 2.0 * c
        q = (wy[..., :, None] * wx[..., None, :]).reshape(b, -1, h * w).to(f.dtype)
        qs.append((q, f.reshape(b, h * w, c)))

    def q_then_bmm():
        for f, wx, wy in level_args:
            b, h, w, c = f.shape
            q = (wy[..., :, None] * wx[..., None, :]).reshape(b, -1, h * w).to(f.dtype)
            torch.bmm(q, f.reshape(b, h * w, c))

    from ood_in_object_detection_torch.ops import library as L
    from ood_in_object_detection_torch.scripts.bench_k3 import queued_ms

    return dict(name=name, route="cuda", source="ood_in_object_detection_torch/csrc/roi_contract.cu",
                replaces=replaces, launches=launches, max_abs_err=err,
                ms=cuda_ms(lambda: [R.roi_contract(*a) for a in level_args]),
                **dispatch_ms(lambda: [L.roi_contract_op(*a) for a in level_args],
                              lambda: [L.roi_contract_cuda(*a) for a in level_args]),
                dispatch_is="three levels, one operator call each",
                device_ms=queued_ms(lambda: [R.roi_contract(*a) for a in level_args], 20),
                plain_ms=cuda_ms(lambda: [R.roi_contract_plain(*a) for a in level_args]),
                **bound(moved, ops, kind),
                library_ms=cuda_ms(lambda: [torch.bmm(q, f) for q, f in qs]),
                library="torch.bmm of the materialised Q (Q built beforehand), per level",
                library_with_q_ms=cuda_ms(q_then_bmm),
                library_with_q="Q = wy * wx formed and cast to the map dtype, then torch.bmm, "
                               "per level, timed together")


def main_candidates(torch, det, images):
    """The NMS inputs of ``det``'s predict step on ``images``: the (B, 1024)
    candidates' class-shifted boxes and their validity."""
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops.fused_detect import select_candidates

    x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    with torch.no_grad():
        raw = det.model(x.contiguous())[0]
    cand = select_candidates(raw, det.nc, CONF, pre_nms_k=1024)
    return N.nms_inputs(cand.boxes, cand.conf, cand.cls, torch.tensor(CONF, device=DEVICE))


def nms_entry(torch, N, shifted, valid, launches, model=None):
    """K1 on the main path's (8, 1024) candidates and, for the main path's
    entry (no ``model``), on controlled boxes at k = 1024, on a chain
    (greedy keeps every second box), on 4096 and 16384 valid boxes and on
    (2, 8400) (640 px's anchor count): keep masks bit-equal to the plain
    version, the wrapper's time and each case's device time per phase
    (mask, sweep; torch.profiler). ``model`` tags another model's entry."""
    from ood_in_object_detection_torch.ops import library as L
    from ood_in_object_detection_torch.scripts import bench_k1_k4 as BK

    cases = {"main_path": (shifted, valid)}
    for label, (b, v) in (BK.k1_cases().items() if model is None else ()):
        cases[label] = (torch.tensor(b, dtype=torch.float32, device=DEVICE),
                        torch.tensor(v, device=DEVICE))
    mism, err = 0, 0.0
    for label, (b, v) in cases.items():
        got = N.greedy_keep(b, v, 0.7)
        ref = N.greedy_keep_plain(b, v, 0.7)
        mism += int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
        if label == "chain" and not torch.equal(ref, (torch.arange(1024, device=DEVICE) % 2 == 0)
                                                .expand_as(ref)):
            raise AssertionError("nms_keep chain: the plain version does not keep every second box")
        emit("kernel_case", kernel="nms_keep", model=model or MODEL, case=label,
             shape=list(b.shape), kept=int(got.sum()), valid=int(v.sum()),
             valid_per_image=v.sum(1).tolist(),
             mismatches=int((got != ref).sum()),
             ms=cuda_ms(lambda: N.greedy_keep(b, v, 0.7)), phase_ms=BK.k1_phase_ms(b, v, 20))
    if mism:
        raise AssertionError(f"nms_keep ({model or MODEL}): {mism} keep-mask entries differ from "
                             "the plain version")
    nv = valid.sum(1).double()
    pairs = float((nv * (nv - 1) / 2).sum())  # IoU tests among valid boxes, ~13 flops each
    return dict(name="nms_keep", **({"model": model} if model else {}), route="cuda",
                source="ood_in_object_detection_torch/csrc/nms_keep.cu",
                replaces="ood_in_object_detection_tpu/ops/pallas/nms.py:65",
                launches=launches, max_abs_err=err,
                ms=cuda_ms(lambda: N.greedy_keep(shifted, valid, 0.7)),
                **({} if model else dispatch_ms(lambda: L.nms_keep_op(shifted, valid, 0.7),
                                                lambda: L.nms_keep_cuda(shifted, valid, 0.7))),
                phase_ms=BK.k1_phase_ms(shifted, valid, 20),
                plain_ms=cuda_ms(lambda: N.greedy_keep_plain(shifted, valid, 0.7)),
                **bound(nbytes(shifted, valid, valid), 13.0 * pairs, "f32"),
                library_ms=None,
                library="none: no single PyTorch call computes a greedy-NMS keep mask")


# K4 against its plain version, of the map's largest magnitude: f32 sums in
# another order; bf16 rounds at other points (stem_entry)
STEM_TOL = {"f32": 2e-5, "bf16": 2.0 ** -5}


def stem_case_params(rng, c1, c2):
    """Seeded (w1, bn1, w2, bn2) at a stem's widths, on the card."""
    import torch

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=DEVICE)

    def bn(c):
        return dict(scale=t(rng.uniform(0.5, 1.5, c)), bias=t(rng.normal(size=c) * 0.1),
                    mean=t(rng.normal(size=c) * 0.1), var=t(rng.uniform(0.5, 2.0, c)))

    return (t(rng.normal(size=(c1, 3, 3, 3)) * 0.5), bn(c1),
            t(rng.normal(size=(c2, c1, 3, 3)) * 0.2), bn(c2))


def stem_modules(torch, params):
    from ood_in_object_detection_torch.models.layers import Conv

    w1, bn1, w2, bn2 = params
    convs = (Conv(3, w1.shape[0], 3, 2), Conv(w1.shape[0], w2.shape[0], 3, 2))
    with torch.no_grad():
        for m, w, p in zip(convs, (w1, w2), (bn1, bn2)):
            m.to(DEVICE).eval()
            m.conv.weight.copy_(w)
            m.bn.weight.copy_(p["scale"])
            m.bn.bias.copy_(p["bias"])
            m.bn.running_mean.copy_(p["mean"])
            m.bn.running_var.copy_(p["var"])
    return convs


def stem_timings(torch, S, m0, m1, x, dt) -> dict:
    """K4 on Conv modules ``m0``, ``m1`` and image ``x`` in ``dt``: the
    wrapper's time (ms), the operator's against its CUDA implementation
    called directly (dispatch_ms), the launcher's on operands folded once
    (kernel_ms), the plain version's, two cuDNN convs + F.silu with BN
    folded (library_ms), and the bound."""
    import torch.nn.functional as F

    from ood_in_object_detection_torch.ops import library as L

    w1, bn1, w2, bn2 = S.stem_conv_params(m0, m1)
    b, _, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    ops = 2.0 * b * ((h // 2) * (w // 2) * c1 * 27 + (h // 4) * (w // 4) * c2 * c1 * 9)
    key = "f32" if dt == torch.float32 else "bf16"
    xi = x.to(dt)
    inv1, b1 = S.bn_fold(bn1)
    inv2, b2 = S.bn_fold(bn2)
    lw1, lw2 = ((w * inv[:, None, None, None]).to(dt) for w, inv in ((w1, inv1), (w2, inv2)))
    lb1, lb2 = b1.to(dt), b2.to(dt)

    def library():
        h1 = F.silu(F.conv2d(xi, lw1, lb1, stride=2, padding=1))
        return F.silu(F.conv2d(h1, lw2, lb2, stride=2, padding=1))

    moved = nbytes(xi) + (w1.numel() + w2.numel()) * xi.element_size() + \
        b * c2 * (h // 4) * (w // 4) * xi.element_size()
    operands = S.k4_operands(w1, bn1, w2, bn2, dt)  # folded once, outside the timing
    args = (xi, w1, *(bn1[k] for k in ("scale", "bias", "mean", "var")),
            w2, *(bn2[k] for k in ("scale", "bias", "mean", "var")), dt == torch.bfloat16)
    return dict(ms=cuda_ms(lambda: S.fused_stem(xi, m0, m1, dt)),
                **dispatch_ms(lambda: L.fused_stem_op(*args), lambda: L.fused_stem_cuda(*args),
                              reps=20),
                kernel_ms=cuda_ms(lambda: S.fused_stem_launch(xi, operands, c1, c2, dt)),
                plain_ms=cuda_ms(lambda: S.fused_stem_plain(xi, w1, bn1, w2, bn2, dt)),
                library_ms=cuda_ms(library), **bound(moved, ops, key))


def stem_entry(torch, S, det, images, launches):
    """K4 at yolov8l's stem on the main path's images (its own layers 0 and
    1), at yolov8n's widths and on a corner impulse, in f32 and bf16; times
    at yolov8l's stem. bf16 tolerance: K4 follows pallas_stem's rounding
    (BN folded into bf16 weights, the conv1 map rounded once), the plain
    version phase_folded_stem's (conv outputs and BN's multiply-add
    rounded): 2^-5 of the map's scale (tests/test_torch_kernels_cuda.py)."""
    x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2).float().contiguous() * (1 / 255)
    impulse = torch.zeros((1, 3, 32, 32), device=DEVICE)
    impulse[0, 0, 0, 0] = 5.0
    rng = np.random.default_rng(SEED + 4)
    v8n = stem_case_params(rng, 16, 32)
    cases = [("yolov8l", x, (det.model.model[0], det.model.model[1])),
             ("yolov8n", x, stem_modules(torch, v8n)),
             ("corner_impulse", impulse, stem_modules(torch, v8n))]
    errs = {}
    for label, inp, (m0, m1) in cases:
        params = S.stem_conv_params(m0, m1)
        for dt in (torch.float32, torch.bfloat16):
            got = S.fused_stem(inp, m0, m1, dt).float()
            ref = S.fused_stem_plain(inp, *params, dt).float()
            e = float((got - ref).abs().max())
            rel = e / float(ref.abs().max())
            key = "f32" if dt == torch.float32 else "bf16"
            errs[key] = max(errs.get(key, 0.0), e)
            emit("kernel_case", kernel="fused_stem", case=label, dtype=key,
                 shape=list(inp.shape), c1=params[0].shape[0], c2=params[2].shape[0], rel_err=rel)
            if rel > STEM_TOL[key]:
                raise AssertionError(f"fused_stem {label} {key}: rel err {rel} > {STEM_TOL[key]}")

    m0, m1 = det.model.model[0], det.model.model[1]
    b, _, h, w = x.shape
    timed = {key: dict(stem_timings(torch, S, m0, m1, x, dt), max_abs_err=errs[key])
             for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
    c1, c2 = m0.conv.out_channels, m1.conv.out_channels
    return dict(name="fused_stem", route="cuda",
                source="ood_in_object_detection_torch/csrc/fused_stem.cu",
                replaces="ood_in_object_detection_tpu/ops/pallas/stem.py:172",
                launches=launches, **timed["f32"], bf16=timed["bf16"],
                library="two F.conv2d (BN folded into weight and bias) + F.silu, cuDNN, "
                        "same dtype", shape=[b, 3, h, w], c1=c1, c2=c2,
                kernel_ms_is="the launcher on operands folded once before timing; ms is the "
                             "wrapper, which folds BN and casts the weights on every call")


def phase_kernels(torch, det, det16, dist_method, images, total, eul_parts, cluster_banks):
    """Each kernel against its plain version on the main paths' tensors;
    ``total``: the launches of every main path's run (e2e, e2e_eul,
    e2e_sweeps, e2e_serve, e2e_bf16, e2e_bundle)."""
    from ood_in_object_detection_torch.ood.pipeline import distance_features
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops import roi_align as R
    from ood_in_object_detection_torch.ops import stem as S

    shifted, valid = main_candidates(torch, det, images)
    out = det.predict(images, conf_thres=CONF)
    entries = []

    entries.append(nms_entry(torch, N, shifted, valid, total["greedy_keep"]))

    # K2: every level's map with the real RoI + exact-tap axis weights, f32
    # (the f32 path) and bf16 (the --bf16 path's maps and boxes)
    entries.append(roi_entry(torch, R, "roi_contract",
                             "ood_in_object_detection_tpu/ops/pallas/roi.py:113", out,
                             total["roi_contract"], 1e-5))
    out16 = det16.predict(images, conf_thres=CONF)
    entries.append(roi_entry(torch, R, "roi_contract_bf16",
                             "ood_in_object_detection_tpu/ops/pallas/roi.py:150", out16,
                             total["roi_contract_bf16"], 1e-5))

    # K3: the real features against the fitted bank (the main path's case,
    # which heads the entry); K 5 banks with empty groups and K 200 banks
    # (K D past 227 KB, two slices of the wide tile), 30 % of the centroids
    # masked out, for cosine and l2. L2 near 0 is sqrt of a cancelled
    # difference (~1e-7 in the square -> ~3e-4 after the root), hence its
    # atol 1e-3. Each case: the wrapper's ms, its device time, its bound and
    # cuBLAS's x @ C.T plus the masked minimum as an observation.
    from ood_in_object_detection_torch.scripts import bench_k3 as BK3

    feats, groups, kmask = dist_method.group_inputs(
        distance_features(dist_method, out, det.neck_channels())[0])
    ng, dd = groups.shape[0], groups.shape[2]
    brng = np.random.default_rng(SEED + 3)
    cases = [("fitted_bank", "cosine", groups, kmask)]
    for kk, masked, empty_every in ((5, 0.3, 7), (200, 0.3, 0)):
        for metric in ("cosine", "l2"):
            cases.append((f"k{kk}_bank", metric,
                          *BK3.bank(brng, ng, kk, dd, masked, empty_every, DEVICE, metric)))
    err, k3_cases = 0.0, []
    for label, metric, cg, km in cases:
        m = BK3.measure(feats, cg, km, metric, reps=20)
        if "error" in m or not m["agrees"]:
            raise AssertionError(f"min_group_distance {label}/{metric}: {m}")
        err = max(err, m["max_abs_err"])
        emit("kernel_case", kernel="min_group_distance", case=f"{label}_{metric}", **m)
        k3_cases.append(dict(case=f"{label}_{metric}", **m))
    main = k3_cases[0]
    entries.append(dict(name="min_group_distance", route="cuda",
                        source="ood_in_object_detection_torch/csrc/min_group_distance.cu",
                        replaces="ood_in_object_detection_tpu/ops/pallas/distance.py:59",
                        launches=total["min_group_distances"], max_abs_err=err,
                        **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "bound_by", "cublas_amin_ms")},
                        library_ms=None,
                        library="none: no single PyTorch call computes the masked minimum "
                                "over each group's centroids (cublas_amin_ms: x @ C.T, then "
                                "the distance, the mask and amin, several calls)",
                        cases=[{k: c[k] for k in ("case", "shape", "valid_centroids", "ms",
                                                  "device_ms", "bound_ms", "bound_by",
                                                  "cublas_amin_ms", "max_abs_err")}
                               for c in k3_cases]))

    # K2 (f32) and K3 at the EUL rank's inputs (e2e_eul); K3 at the sweep's
    # fitted 'all' and 'KMeans' banks (e2e_sweeps)
    entries[1]["eul_rank"] = eul_parts["k2"]
    entries[-1]["eul_rank"] = {k: v for k, v in eul_parts["k3"].items() if k != "agrees"}
    entries[-1]["cluster_banks"] = cluster_banks
    err = max([err] + [b["max_abs_err"] for b in cluster_banks.values()])
    entries[-1]["max_abs_err"] = err

    # K4: the stems of both paths
    entries.append(stem_entry(torch, S, det, images, total["fused_stem"]))

    # every device time of a kernel that launched: 0.0 means the instrument
    # missed the kernel (torch.profiler drops device records late in this
    # script, bench_k3.profile_coverage; K3's device_ms is taken by CUDA
    # events around calls queued behind a spinning kernel, bench_k3.queued_ms)
    probe = BK3.profile_coverage()
    emit("profile_coverage", at="kernels", **probe)
    zero = [path for path, v in device_times(entries) if not v]
    if zero:
        raise AssertionError(f"kernels: the profiler shows no device time at {zero} for "
                             f"kernels that launched (probe: {probe})")
    return entries


def device_times(node, path=""):
    """(path, value) of every ``device_ms`` in a kernels-line entry, nested
    cases included."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "device_ms":
                yield path, v
            else:
                yield from device_times(v, f"{path}/{node.get('name', node.get('case', k))}")
    elif isinstance(node, list):
        for v in node:
            yield from device_times(v, path)


# the l models of the paper's V9-V12 results (e2e_families)
FAMILIES = ("yolov9c", "yolov10l", "yolo11l", "yolo12l")
FAMILY_IND_BATCHES = 2
# each kernel's symbols in the profiler's names
KERNEL_SYMBOLS = {"K1": ("nms_mask_kernel", "nms_sweep_kernel"), "K2": ("roi_contract_kernel",),
                  "K3": ("min_group_kernel",), "K4": ("fused_stem_",)}
PROFILE_ATTEMPTS = 3
PATH_COUNTERS = {"K1": "greedy_keep", "K2": "roi_contract", "K3": "min_group_distances",
                 "K4": "fused_stem"}


def model_seed(name) -> int:
    """The weights' seed: yolov8l's SEED, each family its place in FAMILIES
    (so that the four stems, of one shape, differ)."""
    return SEED if name == MODEL else SEED + 1 + FAMILIES.index(name)


def family_detector(torch, name, images, seed=None):
    """``name`` on the card at 640 px, nc 20, seeded (``seed``, by default
    model_seed), its BatchNorm calibrated on ``images`` (a list of batches)
    and its head spread from seed + 1."""
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm,
                                                             load_jax_variables,
                                                             numpy_state_dict, spread_detect_head)

    seed = model_seed(name) if seed is None else seed
    det = Detector.create(name, nc=NC, img_size=IMG, device=DEVICE,
                          generator=torch.Generator().manual_seed(seed))
    calib = torch.from_numpy(np.concatenate(images)).to(DEVICE)
    calibrate_batchnorm(det.model, calib.permute(0, 3, 1, 2).float() * (1.0 / 255.0))
    del calib
    load_jax_variables(det.model, spread_detect_head(numpy_state_dict(det.model), seed=seed + 1))
    return det


def family_stem_entry(torch, det, images, launches, model, dt):
    """K4 on this model's own stem (layers 0 and 1) and images against the
    plain version, within STEM_TOL."""
    from ood_in_object_detection_torch.ops import stem as S

    key = "f32" if dt == torch.float32 else "bf16"
    x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2).float().contiguous() * (1 / 255)
    m0, m1 = det.model.model[0], det.model.model[1]
    got = S.fused_stem(x, m0, m1, dt).float()
    ref = S.fused_stem_plain(x, *S.stem_conv_params(m0, m1), dt).float()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if rel > STEM_TOL[key]:
        raise AssertionError(f"{model} fused_stem {key}: rel err {rel} > {STEM_TOL[key]}")
    return dict(name="fused_stem", model=model, dtype=key, route="cuda",
                source="ood_in_object_detection_torch/csrc/fused_stem.cu",
                replaces="ood_in_object_detection_tpu/ops/pallas/stem.py:172",
                launches=launches, max_abs_err=err, rel_err=rel,
                **stem_timings(torch, S, m0, m1, x, dt),
                library="two F.conv2d (BN folded into weight and bias) + F.silu, cuDNN, "
                        "same dtype", c1=m0.conv.out_channels, c2=m1.conv.out_channels)


def family_distance_entry(torch, det, dist_method, images, launches, model):
    """K3 on this model's features against its fitted bank (the plain
    version's agreement as bench_k3.measure holds it)."""
    from ood_in_object_detection_torch.ood.pipeline import distance_features
    from ood_in_object_detection_torch.scripts import bench_k3 as BK3

    out = det.predict(images, conf_thres=CONF)
    feats, groups, kmask = dist_method.group_inputs(
        distance_features(dist_method, out, det.neck_channels())[0])
    m = BK3.measure(feats, groups, kmask, "cosine", reps=20)
    if "error" in m or not m["agrees"]:
        raise AssertionError(f"{model} min_group_distance: {m}")
    return dict(name="min_group_distance", model=model, route="cuda",
                source="ood_in_object_detection_torch/csrc/min_group_distance.cu",
                replaces="ood_in_object_detection_tpu/ops/pallas/distance.py:59",
                launches=launches,
                **{k: m[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                     "bound_by", "cublas_amin_ms", "shape", "valid_centroids")},
                library_ms=None,
                library="none: no single PyTorch call computes the masked minimum over each "
                        "group's centroids")


def run_family(torch, name, ind_imgs, ood_imgs, dtype, weights=None):
    """One model's main path: build (or take ``weights``), label, extract ->
    fit -> evaluate with the counters reset just before and read just
    after; K1-K4 must launch. Then its predict step, launches per step,
    device time by kernel and the CPU reference (f32). -> (det, methods,
    ood batches, launches, the phase line's fields)."""
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method

    if weights is None:
        det = family_detector(torch, name, ind_imgs + ood_imgs)
    else:
        det = Detector.create(name, nc=NC, img_size=IMG, device=DEVICE, dtype=dtype)
        det.model.load_state_dict(weights)
    ind = label_batches(det, ind_imgs)
    ood = label_batches(det, ood_imgs, unknown_every=3)
    reset_counters()
    t0 = time.perf_counter()
    methods, results, n_clusters = run_methods(det, ind, ood)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    k2 = "roi_contract" if dtype == torch.float32 else "roi_contract_bf16"
    path = dict(PATH_COUNTERS, K2=k2)
    if det.model.stem_route != "fused" or not all(launches[k] for k in path.values()):
        raise AssertionError(f"{name}: the path did not launch K1-K4 "
                             f"(stem route {det.model.stem_route}): {launches}")
    images = ood_imgs[0]
    out = det.predict(images, conf_thres=CONF)
    taps = (out.roi_feats.float(), out.exact_feats.float()) + tuple(f.float() for f in out.neck)
    for t in (out.det.boxes, out.det.conf, out.logits) + taps:
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite predict output")
    if any(f.dtype != dtype for f in out.neck):
        raise AssertionError(f"{name}: taps are not {dtype}")
    reset_counters()
    det.predict(images, conf_thres=CONF)
    torch.cuda.synchronize()
    per_step = {k: read_counters()[c] for k, c in path.items()}  # K3: 0, predict runs none
    step_ms = cuda_ms(lambda: det.predict(images, conf_thres=CONF), reps=10)
    # K3 runs in the distance decisions of an evaluated batch, not in predict.
    # The profiler has once shown no record of K3's 6 us kernel, which the
    # launch counters had seen: profile again, up to PROFILE_ATTEMPTS times,
    # and print the attempts taken
    cos = methods["Cosine_cl_stride"]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        rows, _ = profile_rows(torch, lambda: det.predict(images, conf_thres=CONF))
        k3_rows, _ = profile_rows(
            torch, lambda: _decisions_for_method(cos, out, det.neck_channels()), steps=5)
        kernel_us = {k: sum(t for t, key, _ in (k3_rows if k == "K3" else rows)
                            if any(sym in key for sym in syms))
                     for k, syms in KERNEL_SYMBOLS.items()}
        if not rows or all(kernel_us.values()):
            break
    if rows and not all(kernel_us.values()):
        raise AssertionError(f"{name}: the profiler shows no time in {kernel_us} "
                             f"({len(rows)} predict rows, {len(k3_rows)} decision rows, "
                             f"{attempt} attempts)")
    device_us = sum(r[0] for r in rows)
    depthwise_us = sum(t for t, key, _ in rows if "depthwise" in key)
    head = det.model.model[-1]
    if head.dual:  # the one2many branches on this batch's neck taps: work predict skips
        x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2).float() * (1.0 / 255.0)
        with torch.no_grad():
            neck = det.model(x.contiguous())[1]
            o2m_rows, _ = profile_rows(torch, lambda: [seq(f) for seqs in (head.cv2, head.cv3)
                                                       for seq, f in zip(seqs, neck)])
        skipped = dict(device_ms=sum(r[0] for r in o2m_rows) / 1e3,
                       depthwise_ms=sum(t for t, key, _ in o2m_rows if "depthwise" in key) / 1e3)
    fields = dict(model=name, dtype="float32" if dtype == torch.float32 else "bfloat16",
                  img_size=IMG, nc=NC, batch=BATCH, ind_batches=len(ind_imgs),
                  params=sum(p.numel() for p in det.model.parameters()),
                  stem_route=det.model.stem_route,
                  stem_widths=list(det.model.stem_widths),
                  detect_layer=det.model.detect_layer_idx,
                  neck_channels=list(det.neck_channels()), eval_seconds=seconds,
                  launches=launches, launches_per_step=per_step,
                  predict_step_ms=step_ms, images_per_s=BATCH * 1000.0 / step_ms,
                  device_ms_per_step=device_us / 1e3 if rows else "not measured",
                  device_busy_share=device_us / (step_ms * 1e3) if rows else "not measured",
                  kernel_ms_per_step={k: v / 1e3 for k, v in kernel_us.items()} if rows
                  else "not measured",
                  kernel_ms_per_step_is="K1, K2, K4: the predict step; K3: one batch's "
                                        "Cosine_cl_stride decisions",
                  profile_attempts=attempt,
                  top=[{"name": k[:80], "us_per_step": t} for t, k, _ in rows[:8]],
                  depthwise_ms_per_step=depthwise_us / 1e3 if rows else "not measured",
                  **({"one2many_skipped": skipped} if head.dual else {}),
                  metrics=results, clusters=n_clusters,
                  detections_per_image=float(out.det.valid.sum(1).float().mean()))
    return det, methods, ood, launches, fields


def phase_e2e_families(torch) -> list:
    """yolov9c, yolov10l, yolo11l and yolo12l through the eval path at 640
    px, batch 8, f32 with TF32 off; yolo12l again in bf16. Per model one
    line (phase_e2e_families), the CPU reference, and K1-K4 held against
    their plain versions on its own tensors: kernel entries tagged with the
    model."""
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops import roi_align as R

    rng = np.random.default_rng(SEED + 10)
    ind_imgs, ood_imgs = make_batches(rng, FAMILY_IND_BATCHES), make_batches(rng, 1)
    entries, t_phase = [], time.perf_counter()
    for name in FAMILIES:
        det, methods, ood, launches, fields = run_family(torch, name, ind_imgs, ood_imgs,
                                                         torch.float32)
        emit("e2e_families", **fields)
        images = ood[0]["images"]
        phase_reference(torch, det, images, label="reference_family", model=name)
        with torch.no_grad():
            entries.append(nms_entry(torch, N, *main_candidates(torch, det, images),
                                     launches["greedy_keep"], model=name))
            k2 = roi_entry(torch, R, "roi_contract",
                           "ood_in_object_detection_tpu/ops/pallas/roi.py:113",
                           det.predict(images, conf_thres=CONF), launches["roi_contract"], 1e-5,
                           model=name)
            entries.append(dict(k2, model=name))
            entries.append(family_distance_entry(torch, det, methods["Cosine_cl_stride"], images,
                                                 launches["min_group_distances"], name))
            entries.append(family_stem_entry(torch, det, images, launches["fused_stem"], name,
                                             torch.float32))
        if name == "yolo12l":  # attention, K2b and K4 in bf16 at full width
            weights = det.model.state_dict()
            det16, _, ood16, launches16, fields16 = run_family(
                torch, name, ind_imgs, ood_imgs, torch.bfloat16, weights=weights)
            emit("e2e_families", **fields16)
            with torch.no_grad():
                images = ood16[0]["images"]
                k2b = roi_entry(torch, R, "roi_contract_bf16",
                                "ood_in_object_detection_tpu/ops/pallas/roi.py:150",
                                det16.predict(images, conf_thres=CONF),
                                launches16["roi_contract_bf16"], 1e-5, model=name)
                entries.append(dict(k2b, model=name))
                entries.append(family_stem_entry(torch, det16, images, launches16["fused_stem"],
                                                 name, torch.bfloat16))
            del det16
        del det
        torch.cuda.empty_cache()
    emit("e2e_families_done", seconds=time.perf_counter() - t_phase)
    return entries


# training and its validation (e2e_train): a seeded scenes dataset labelled
# by e2e's detector, yolov8l trained through cli.train at 640 px
TRAIN_IMAGES, VAL_IMAGES = 64, 16
TRAIN_BATCH = 16
TRAIN_EPOCHS = 2
OVERFIT_STEPS, OVERFIT_BATCH = 25, 8
# the overfit check's bound on last / first loss. tests/test_train.py holds
# yolov8n at 96 px to 0.6; at yolov8l, 640 px, its batch and schedule read
# 0.622-0.644 (f32) and 0.633 (bf16) on the H100 (the curve still falls ~1 %
# a step: the warmup keeps the weights' LR under 2.5e-3 for these 25
# steps), while yolov8n at 640 px reads 0.270 in the port and 0.237 in JAX
# on the CPU (PERF.md section 6)
OVERFIT_RATIO = 0.7
V10_MODEL, V10_STEPS = "yolov10l", 2
# one f32 train step at batch TRAIN_REF_BATCH on the card against the CPU,
# from the same weights (seeded) and batch: the loss terms (relative) and
# the update p1 - p0 of all trained tensors together (L2 of card - CPU over
# L2 of the CPU's; each tensor's own is printed: it reads up to ~8e-3 in
# the few whose gradients cancel). Set from `python3 chip_smoke.py
# --reference-seeds 4` (train_spread: seeds 0-3, sound, with the card's LR
# scaled by 1 + TRAIN_REF_FAULT, and with TF32 on for the card's step;
# PERF.md section 5): sound at most 6.3e-5 (loss) and 8.9e-4 (update),
# the limits ~4.5x above; TF32 moves the update by 0.18-0.56. An LR off by
# 1e-3 (0.88-1.29e-3) does not stand out of one step's noise.
TRAIN_REF_BATCH = 2
TRAIN_REF_FAULT = 1e-3
TRAIN_REF_LIMITS = {"loss_rel": 3e-4, "update_rel": 4e-3}
VAL_CONF = 0.001  # the validator's (cli/train.py:validate)


def write_train_dataset(torch, det, root):
    """TRAIN_IMAGES + VAL_IMAGES seeded scenes labelled by ``det`` (its own
    detections at CONF, up to 20 an image) as one dataset with train and
    val splits; -> the yaml."""
    rng = np.random.default_rng(SEED + 13)
    train = label_batches(det, make_scenes(rng, TRAIN_IMAGES // BATCH))
    val = label_batches(det, make_scenes(rng, VAL_IMAGES // BATCH))
    for b in val:
        b["im_names"] = ["v" + n for n in b["im_names"]]
    write_dataset(root, train + val)
    lines = (root / "split.txt").read_text().splitlines()
    (root / "train.txt").write_text("\n".join(lines[:TRAIN_IMAGES]) + "\n")
    (root / "val.txt").write_text("\n".join(lines[TRAIN_IMAGES:]) + "\n")
    (root / "train.yaml").write_text(
        "path: .\ntrain: train.txt\nval: val.txt\nnames:\n"
        + "".join(f"  {k}: c{k}\n" for k in range(NC)))
    return root / "train.yaml"


def cli_device() -> str:
    return "cpu" if DEVICE == "cpu" else "0"


START_CLS_SCALE = 0.5


def start_checkpoint(torch, det, path) -> None:
    """``det``'s weights (BatchNorm calibrated, head spread) as a training
    state at epoch -1, which ``cli.train --resume`` starts at epoch 0 (the
    way a JAX checkpoint's weights start a port training run, README.md),
    the head's biases back at their init and its class weights scaled by
    START_CLS_SCALE: background confidences of ~e^-8 with a tail above
    0.001, so that validation's conf 0.001 fills each image's 1024
    candidates, as a trained network's does, while the reference's warmup
    bias LR (0.1) does not drive the class biases off (from the spread
    head's confidences of ~0.5 everywhere it did: the class loss rose
    from 2.8e3 to 4.9e5 in two epochs)."""
    from ood_in_object_detection_torch.core.checkpoint import save_checkpoint
    from ood_in_object_detection_torch.models import build_model
    from ood_in_object_detection_torch.train import trainer as TTR

    m = build_model(MODEL, nc=NC)
    m.load_state_dict({k: v.cpu() for k, v in det.model.state_dict().items()})
    head = m.model[m.detect_layer_idx]
    head.bias_init()
    with torch.no_grad():
        for cls in head.cv3:
            cls[-1].weight.mul_(START_CLS_SCALE)
    save_checkpoint(path, TTR.init_state(m, TTR.TrainConfig()), {"name": "start", "nc": NC},
                    MODEL, epoch=-1)


def train_cli_args(yaml, out_dir, name, *extra):
    return ["--dataset", str(yaml), "--model_version", MODEL[:-1], "--model", MODEL[-1],
            "--img_size", str(IMG), "--batch_size", str(TRAIN_BATCH), "--workers", "4",
            "--epochs", str(TRAIN_EPOCHS), "--val_every", "1", "--max_gt", "20",
            "--device", cli_device(), "--out_dir", str(out_dir), "--name", name,
            "--no_tensorboard", *extra]


def seeded_model(torch, name, dtype=None, seed=SEED):
    """``name`` seeded on the card (f32 parameters, ``dtype`` compute)."""
    from ood_in_object_detection_torch.models import build_model, init_weights

    m = build_model(name, nc=NC, dtype=dtype or torch.float32)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(DEVICE)


def step_readings(torch, batch, dtype=None, remat=False, steps=10, profile=False) -> dict:
    """A fresh seeded yolov8l's train step on a device ``batch``: CUDA-event
    ms (mean of ``steps`` after 2 warm-up), peak memory, the last loss, and
    with ``profile`` the device time by op (torch.profiler, 2 steps)."""
    from ood_in_object_detection_torch.train import trainer as TTR

    model = seeded_model(torch, MODEL, dtype)
    cfg = TTR.TrainConfig(remat=remat)  # the CLI's schedule: these steps are in its warmup
    state = TTR.init_state(model, cfg)
    last = {}

    def step():
        last["lb"] = TTR.train_step(model, cfg, state, batch)[1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, reps=steps, warmup=2)
    out = dict(dtype=str(dtype or torch.float32).replace("torch.", ""), remat=remat,
               batch=int(batch["images"].shape[0]), step_ms=ms,
               images_per_s=batch["images"].shape[0] * 1000.0 / ms,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss={k: float(getattr(last["lb"], k)) for k in ("total", "box", "cls", "dfl")})
    if not all(np.isfinite(v) for v in out["loss"].values()):
        raise AssertionError(f"train step: non-finite loss {out}")
    if profile:
        rows, host = profile_rows(torch, step, steps=2)
        device_us = sum(r[0] for r in rows)
        out.update(kernels_per_step=sum(r[2] for r in rows),
                   device_ms_per_step=device_us / 1000.0 if rows else "not measured",
                   device_busy_share=device_us / (ms * 1000.0) if rows else "not measured",
                   top=[{"name": k[:90], "us_per_step": t, "calls_per_step": c}
                        for t, k, c in rows[:15]],
                   host_top=[{"name": k[:60], "host_us_per_step": t} for t, k, _ in host[:8]])
    del model, state
    torch.cuda.empty_cache()
    return out


def overfit_batch(b: int) -> dict:
    """tests/test_train.py's fixed batch at IMG px: seeded uniform noise
    images in [0, 1] and its two boxes an image (96 px there) scaled to it,
    the two images' patterns alternating."""
    boxes = np.array([[[10, 10, 50, 50], [60, 20, 90, 80]],
                      [[20, 30, 70, 90], [5, 5, 40, 40]]], np.float32) * (IMG / 96)
    labels = np.array([[0, 1], [1, 0]], np.int32)
    images = np.random.default_rng(SEED + 17).uniform(0, 1, (b, IMG, IMG, 3)).astype(np.float32)
    return dict(images=images, gt_bboxes=boxes[np.arange(b) % 2],
                gt_labels=labels[np.arange(b) % 2], gt_mask=np.ones((b, 2), bool))


def overfit_reading(torch, batch, dtype=None) -> dict:
    """tests/test_train.py:106-136 at full width: OVERFIT_STEPS steps of a
    fresh seeded yolov8l on one fixed batch (the JAX test's config); ``ok``
    where the last loss is below OVERFIT_RATIO x the first and the EMA moved
    off the init."""
    from ood_in_object_detection_torch.train import trainer as TTR

    model = seeded_model(torch, MODEL, dtype)
    cfg = TTR.TrainConfig(lr0=0.01, epochs=100, steps_per_epoch=1, warmup_epochs=0.1)
    state = TTR.init_state(model, cfg)
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    losses = [float(TTR.train_step(model, cfg, state, batch)[1].total)
              for _ in range(OVERFIT_STEPS)]
    ema_moved = max(float((state.ema[k] - ema0[k]).abs().max()) for k in ema0)
    out = dict(dtype=str(dtype or torch.float32).replace("torch.", ""), steps=OVERFIT_STEPS,
               batch=int(batch["images"].shape[0]), first_loss=losses[0], last_loss=losses[-1],
               ratio=losses[-1] / losses[0], losses=losses, ema_max_move=ema_moved,
               ok=bool(np.isfinite(losses).all() and losses[-1] < OVERFIT_RATIO * losses[0]
                       and ema_moved > 0))
    del model, state
    torch.cuda.empty_cache()
    return out


def train_reference_batch(seed: int):
    """TRAIN_REF_BATCH seeded scenes with 3 seeded boxes each (host)."""
    rng = np.random.default_rng(SEED + 2000 + seed)
    images = make_scenes(rng, 1)[0][:TRAIN_REF_BATCH].astype(np.float32) / 255.0
    xy = rng.uniform(0, 0.65 * IMG, (TRAIN_REF_BATCH, 3, 2))
    wh = rng.uniform(IMG / 16, IMG / 3, (TRAIN_REF_BATCH, 3, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return dict(images=images, gt_bboxes=boxes,
                gt_labels=rng.integers(0, NC, (TRAIN_REF_BATCH, 3)).astype(np.int32),
                gt_mask=np.ones((TRAIN_REF_BATCH, 3), bool))


def train_reference_reading(torch, seed: int = 0, fault: str = "") -> dict:
    """One f32 train step of seeded yolov8l on the card and on the CPU from
    the same weights and batch; ``fault`` "lr" scales the card's LR by 1 +
    TRAIN_REF_FAULT, "tf32" lets the card's matmuls and convolutions take
    TF32. -> the loss terms' largest relative error, the update's relative
    L2 error over all trained tensors, and the worst tensor's own."""
    import copy

    from ood_in_object_detection_torch.train import trainer as TTR

    gpu = seeded_model(torch, MODEL, seed=SEED + 1000 * seed)
    cpu = copy.deepcopy(gpu).to("cpu")
    p0 = {n: p.detach().cpu().clone() for n, p in cpu.named_parameters()}
    batch = train_reference_batch(seed)
    losses = {}
    for key, m, lr in (("cuda", gpu, 0.01 * (1 + (TRAIN_REF_FAULT if fault == "lr" else 0.0))),
                       ("cpu", cpu, 0.01)):
        cfg = TTR.TrainConfig(lr0=lr, warmup_epochs=0.0)
        tf32 = key == "cuda" and fault == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        try:
            losses[key] = TTR.train_step(m, cfg, TTR.init_state(m, cfg), batch)[1]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        losses[key + "_s"] = time.perf_counter() - t0
    loss_rel = max(abs(float(getattr(losses["cuda"], k)) - float(getattr(losses["cpu"], k)))
                   / abs(float(getattr(losses["cpu"], k))) for k in ("total", "box", "cls", "dfl"))
    num = den = worst = 0.0
    worst_name, moved = "", 0
    g = dict(gpu.named_parameters())
    for n, p in cpu.named_parameters():
        u_cpu = (p.detach() - p0[n]).double()
        d = ((g[n].detach().cpu() - p0[n]).double() - u_cpu).norm() ** 2
        scale = u_cpu.norm() ** 2
        if scale == 0:
            continue
        moved += 1
        num, den = num + float(d), den + float(scale)
        if float(d / scale) > worst:
            worst, worst_name = float(d / scale), n
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(seed=seed, fault=fault or None, loss_rel=loss_rel, update_rel=(num / den) ** 0.5,
                worst_tensor=worst_name, worst_tensor_rel=worst ** 0.5, tensors_moved=moved,
                loss_cuda=float(losses["cuda"].total), loss_cpu=float(losses["cpu"].total),
                cpu_step_s=losses["cpu_s"])


def train_spread(torch, n_seeds: int) -> None:
    """The readings TRAIN_REF_LIMITS stand on: n_seeds seeds, sound, with the
    card's LR scaled by 1 + TRAIN_REF_FAULT and with TF32 on the card.
    Asserts nothing."""
    worst = {}
    for s in range(n_seeds):
        for fault in ("", "lr", "tf32"):
            r = train_reference_reading(torch, s, fault)
            emit("train_reference_reading", **r)
            w = worst.setdefault(fault or "sound", dict(loss_rel=[], update_rel=[]))
            w["loss_rel"].append(r["loss_rel"])
            w["update_rel"].append(r["update_rel"])
    emit("train_spread", seeds=n_seeds, lr_fault=TRAIN_REF_FAULT,
         sound_worst={k: max(v) for k, v in worst["sound"].items()},
         fault_least={f: {k: min(v) for k, v in worst[f].items()} for f in ("lr", "tf32")},
         limits=TRAIN_REF_LIMITS)


def val_candidates(torch, det, images):
    """The NMS inputs of validation's predict step (conf VAL_CONF) on float
    images (B, H, W, 3) in [0, 1]."""
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops.fused_detect import select_candidates

    x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        raw = det.model(x)[0]
    cand = select_candidates(raw, det.nc, VAL_CONF, pre_nms_k=1024)
    return N.nms_inputs(cand.boxes, cand.conf, cand.cls, torch.tensor(VAL_CONF, device=DEVICE))


def phase_e2e_train(torch, det) -> list:
    """Training and validation at full width; -> the K1 and K2 entries of
    validation's own tensors (``case: val_conf0.001``)."""
    import copy
    import json as _json
    import shutil
    import tempfile
    from pathlib import Path
    from unittest import mock

    from ood_in_object_detection_torch.cli import train as ttrain
    from ood_in_object_detection_torch.cli import val as tval
    from ood_in_object_detection_torch.core import checkpoint as CK
    from ood_in_object_detection_torch.data import DetectionDataset, PaddedBatcher
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops import roi_align as R
    from ood_in_object_detection_torch.train import trainer as TTR
    from ood_in_object_detection_torch.train.loss import detection_loss

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="e2e_train_"))
    try:
        yaml = write_train_dataset(torch, det, tmp / "data")
        start = tmp / "start"
        start_checkpoint(torch, det, start)
        t_data = time.perf_counter() - t_phase

        # 1. cli.train, f32, augmentation on, validation every epoch with the
        # counters reset just before and read just after each validate
        vals, real_validate = [], ttrain.validate

        def counted_validate(model, state, val_ds, args, nc):
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            metrics = real_validate(model, state, val_ds, args, nc)
            torch.cuda.synchronize()
            vals.append(dict(seconds=time.perf_counter() - t0, launches=read_counters(),
                             mAP50=float(metrics["mAP50"]), mAP50_95=float(metrics["mAP50_95"]),
                             model=model, ema={k: v.detach().clone()
                                               for k, v in state.ema_params.items()}))
            return metrics

        t0 = time.perf_counter()
        with mock.patch.object(ttrain, "validate", counted_validate):
            ttrain.main(train_cli_args(yaml, tmp / "runs", "f32", "--close_mosaic", "0",
                                       "--resume", str(start)))
        train_s = time.perf_counter() - t0
        run = tmp / "runs" / "f32"
        rows = [ln.split(",") for ln in (run / "results.csv").read_text().splitlines()[1:]]
        epochs = [dict(epoch=int(r[0]), seconds=float(r[1]),
                       images_per_s=TRAIN_IMAGES / float(r[1]), box=float(r[2]),
                       cls=float(r[3]), dfl=float(r[4]), total=float(r[5]), lr=float(r[6]),
                       mAP50=float(r[7]), mAP50_95=float(r[8])) for r in rows]
        if len(vals) != TRAIN_EPOCHS or len(epochs) != TRAIN_EPOCHS:
            raise AssertionError(f"cli.train: {len(vals)} validations, {len(epochs)} rows")
        for v in vals:
            if not (np.isfinite(v["mAP50"]) and np.isfinite(v["mAP50_95"])):
                raise AssertionError(f"validate: non-finite mAP {v}")
            missing = [k for k in ("fused_stem", "greedy_keep", "roi_contract")
                       if not v["launches"][k]]
            if missing or v["launches"]["roi_contract_bf16"]:
                raise AssertionError(f"validate did not launch {missing}: {v['launches']}")
        emit("e2e_train_cli", model=MODEL, img_size=IMG, nc=NC, batch=TRAIN_BATCH,
             images=TRAIN_IMAGES, val_images=VAL_IMAGES, augment="mosaic, HSV, flip",
             seconds=train_s, dataset_seconds=t_data, epochs=epochs,
             validate=[{k: v[k] for k in ("seconds", "launches", "mAP50", "mAP50_95")}
                       for v in vals])

        # 2. cli.val on the last checkpoint: its --out equals validate's numbers
        out_json = tmp / "val.json"
        t0 = time.perf_counter()
        tval.main(["--model_path", str(run), "--dataset", str(yaml), "--img_size", str(IMG),
                   "--batch_size", str(TRAIN_BATCH), "--max_gt", "20", "--device", cli_device(),
                   "--out", str(out_json)])
        val_s = time.perf_counter() - t0
        got = _json.loads(out_json.read_text())
        last = vals[-1]
        if any(abs(got[k] - last[k]) > 1e-6 for k in ("mAP50", "mAP50_95")):
            raise AssertionError(f"cli.val {got} against validate {last['mAP50']}, "
                                 f"{last['mAP50_95']}")

        # 3. resume: --resume from the epoch-0 checkpoint continues at epoch 1,
        # its first step's loss that of the uninterrupted run (letterboxed
        # batches in order, --no_augment, so that both see the same batches)
        step_losses, real_step = [], TTR.train_step

        def recorded_step(*a, **kw):
            state, lb = real_step(*a, **kw)
            step_losses.append(float(lb.total))
            return state, lb

        epoch0, real_save = tmp / "epoch0", CK.save_checkpoint

        def save_and_keep(path, state, train_args, model_name, epoch=0):
            real_save(path, state, train_args, model_name, epoch)
            if epoch == 0:
                shutil.copytree(path, epoch0)

        plain = ("--no_augment", "--do_not_val_during_training")
        with mock.patch.object(TTR, "train_step", recorded_step), \
                mock.patch.object(CK, "save_checkpoint", save_and_keep):
            ttrain.main(train_cli_args(yaml, tmp / "runs", "whole", *plain,
                                       "--resume", str(start)))
        whole = list(step_losses)
        step_losses.clear()
        with mock.patch.object(TTR, "train_step", recorded_step):
            ttrain.main(train_cli_args(yaml, tmp / "runs", "resumed", *plain,
                                       "--resume", str(epoch0)))
        spe = TRAIN_IMAGES // TRAIN_BATCH
        meta = _json.loads((tmp / "runs" / "resumed" / "meta.json").read_text())
        resume = dict(steps_whole=len(whole), steps_resumed=len(step_losses),
                      loss_whole=whole[spe], loss_resumed=step_losses[0],
                      rel=abs(step_losses[0] - whole[spe]) / abs(whole[spe]),
                      resumed_epoch=meta["epoch"])
        if not (len(whole) == 2 * spe and len(step_losses) == spe and meta["epoch"] == 1
                and resume["rel"] <= 1e-6):
            raise AssertionError(f"resume: {resume}")
        emit("e2e_train_resume", **resume, cli_val=got, cli_val_seconds=val_s)

        # 4. K1 and K2 on validation's own tensors (the EMA model, conf 0.001)
        vmodel = copy.deepcopy(last["model"])
        vmodel.load_state_dict(last["ema"])
        vdet = Detector(model=vmodel.eval(), img_size=IMG)
        val_ds = DetectionDataset.from_yaml(str(yaml), split="val")
        vb = next(iter(PaddedBatcher(val_ds, TRAIN_BATCH, IMG, max_gt=20, workers=4)))
        with torch.no_grad():
            shifted, valid = val_candidates(torch, vdet, vb["images"])
            k1 = nms_entry(torch, N, shifted, valid, last["launches"]["greedy_keep"], model=MODEL)
            k1.update(case="val_conf0.001", valid_per_image=valid.sum(1).tolist())
            out = vdet.predict(vb["images"], conf_thres=VAL_CONF)
            k2 = roi_entry(torch, R, "roi_contract",
                           "ood_in_object_detection_tpu/ops/pallas/roi.py:113", out,
                           last["launches"]["roi_contract"], 1e-5, model=MODEL)
            # the EMA model's eval-mode maps after a few warmup steps can be
            # huge (BatchNorm biases moved at the warmup's bias LR, running
            # statistics trailing): the error beside the maps' scale
            scale = max(float(f.abs().max()) for f in out.neck)
            k2.update(case="val_conf0.001", map_scale=scale,
                      max_abs_err_over_map_scale=k2["max_abs_err"] / scale)
        del vdet, vmodel, vals
        torch.cuda.empty_cache()

        # 5. a train step's time, device time by op and peak memory: f32,
        # f32 with remat, bf16 (batch TRAIN_BATCH); the overfit check in f32
        # and bf16 (batch OVERFIT_BATCH)
        tb = next(iter(PaddedBatcher(DetectionDataset.from_yaml(str(yaml), split="train"),
                                     TRAIN_BATCH, IMG, max_gt=20, workers=4)))
        batch = TTR.batch_to(tb, DEVICE)
        small = TTR.batch_to(overfit_batch(OVERFIT_BATCH), DEVICE)
        steps = [step_readings(torch, batch, profile=True),
                 step_readings(torch, batch, remat=True),
                 step_readings(torch, batch, dtype=torch.bfloat16)]
        for s in steps:
            emit("e2e_train_step", **s)
        overfit = [overfit_reading(torch, small), overfit_reading(torch, small, torch.bfloat16)]
        emit("e2e_train_overfit", runs=overfit)
        if not all(r["ok"] for r in overfit):
            raise AssertionError(f"overfit: {overfit}")

        # 6. one f32 step on the card against the CPU
        ref = train_reference_reading(torch)
        emit("e2e_train_reference", **ref, limits=TRAIN_REF_LIMITS)
        if ref["loss_rel"] > TRAIN_REF_LIMITS["loss_rel"] or \
                ref["update_rel"] > TRAIN_REF_LIMITS["update_rel"]:
            raise AssertionError(f"train step card against CPU: {ref}")

        # 7. yolov10l: the one2one loss alone leaves the backbone and neck
        # without gradient on the card; V10_STEPS steps of the dual loss
        m = seeded_model(torch, V10_MODEL)
        m.train()
        args = (small["gt_labels"], small["gt_bboxes"], small["gt_mask"], NC)
        one2one = m(small["images"])[0]
        detection_loss(one2one, *args, assign_topk=1).total.backward()
        head = f"model.{m.detect_layer_idx}."
        body = [p for n, p in m.named_parameters() if not n.startswith(head)]
        body_grad = sum(float(p.grad.abs().sum()) for p in body if p.grad is not None)
        o2o_grad = sum(float(p.grad.abs().sum()) for n, p in m.named_parameters()
                       if n.startswith(head + "one2one_") and p.grad is not None)
        m.zero_grad(set_to_none=True)
        cfg = TTR.TrainConfig(warmup_epochs=0.0)
        state = TTR.init_state(m, cfg)
        v10 = [{k: float(getattr(TTR.train_step(m, cfg, state, small)[1], k))
                for k in ("total", "box", "cls", "dfl")} for _ in range(V10_STEPS)]
        emit("e2e_train_v10", model=V10_MODEL, batch=OVERFIT_BATCH,
             backbone_grad_from_one2one=body_grad, one2one_head_grad=o2o_grad, losses=v10)
        if body_grad != 0.0 or o2o_grad <= 0 or \
                not all(np.isfinite(v) for row in v10 for v in row.values()):
            raise AssertionError(f"{V10_MODEL}: one2one gradient {body_grad} into the body, "
                                 f"head {o2o_grad}, losses {v10}")
        del m, state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("e2e_train_done", seconds=time.perf_counter() - t_phase)
    return [k1, k2]


# the stem ladder's kernels: (source, the rung whose numbers head the entry)
STEM_PARTS = {
    "window_copy": ("stem_parts_copy", "stem kernel [io]"),
    "shift_add": ("stem_parts_shift", "tiled + shift concat"),
    "stem_gemm": ("stem_parts_mm", "stem kernel [full]"),
}
STEM_PARTS_GEMM_TOL = 2.0 ** -7  # of the output's largest magnitude


def phase_stem_parts(torch, size=(128, 160, 160)) -> list:
    """The ladder entry point at full size with the counters reset, then
    every rung's kernel against its plain version; -> three kernel entries."""
    from ood_in_object_detection_torch.scripts import bench_stem_parts as BSP

    b, h, w = size
    reset_counters()
    t0 = time.perf_counter()
    with torch.no_grad():
        BSP.main(["--device", DEVICE, "--batch", str(b), "--height", str(h), "--width", str(w)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    if not all(launches[k] for k in STEM_PARTS):
        raise AssertionError(f"the ladder did not launch its kernels: {launches}")
    emit("stem_parts", size=[b, h, w], seconds=seconds, launches=launches)

    rungs = {k: [] for k in STEM_PARTS}
    for ladder in (1, 2, 3, 4):
        inputs = BSP.make_inputs(ladder, b, h, w, SEED, DEVICE)
        for rung in (r for r in BSP.RUNGS if r.ladder == ladder and r.kind != "library"):
            kernel = BSP.KERNEL_OF[rung.kind]
            got = BSP.call(rung, inputs)
            ref = BSP.call(rung, inputs, plain=True)
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            exact = bool(torch.equal(got, ref))
            ok = exact if rung.kind != "mm" else err <= STEM_PARTS_GEMM_TOL * scale
            emit("kernel_case", kernel=STEM_PARTS[kernel][0], case=rung.name, ladder=ladder,
                 replaces=rung.site, shape=list(got.shape), max_abs_err=err,
                 rel_err=err / scale if scale else 0.0, bit_exact=exact)
            if not ok:
                raise AssertionError(f"{kernel} rung {rung.name!r}: err {err} (scale {scale})")
            lib = BSP.library_call(rung, inputs)
            moved, ops = BSP.cost(rung, inputs, got)
            gemm = {}
            if rung.kind == "mm":  # the rung from library calls
                gemm = dict(library_composite_ms=cuda_ms(
                    lambda: BSP.stem_gemm_composite(inputs["z"], inputs, rung.arg)))
            rungs[kernel].append(dict(
                rung=rung.name, replaces=rung.site, max_abs_err=err,
                ms=cuda_ms(lambda: BSP.call(rung, inputs)),
                plain_ms=cuda_ms(lambda: BSP.call(rung, inputs, plain=True)),
                **BSP.bound(moved, ops),
                library_ms=None if lib is None else cuda_ms(lib), **gemm))
            del got, ref
        del inputs
    entries = []
    for kernel, (source, head) in STEM_PARTS.items():
        top = next(r for r in rungs[kernel] if r["rung"] == head)
        lib = ("Tensor.copy_ of the slice into a tensor allocated beforehand" if
               top["library_ms"] is not None else BSP.LIBRARY_NONE[
                   "shift" if kernel == "shift_add" else "mm"])
        entries.append(dict(
            name=source, route="cuda", source=f"ood_in_object_detection_torch/csrc/{source}.cu",
            replaces=", ".join(sorted({r["replaces"] for r in rungs[kernel]})),
            launches=launches[kernel], headline_rung=head,
            max_abs_err=max(r["max_abs_err"] for r in rungs[kernel]),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "library_composite_ms") if k in top},
            library=lib, shape=[b, h, w], rungs=rungs[kernel]))
    return entries


def main() -> int:
    import argparse
    import tempfile
    from pathlib import Path

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--reference-seeds", type=int, default=0, metavar="N",
                    help="only take the card-vs-CPU reference readings of yolov8l and the "
                         "families on N seeds, sound and with a fault (reference_spread, "
                         "train_spread), and print no result")
    ap.add_argument("--only", choices=["e2e_train", "e2e_dp", "e2e_clusters", "e2e_sp",
                                       "e2e_sp_train"],
                    default="",
                    help="run this phase alone (after env and build, on a detector of its "
                         "own; e2e_dp with e2e_serve's checkpoint and datasets written "
                         "first, e2e_clusters on e2e_sweeps' scenes), print its kernel "
                         "entries (e2e_train) and no result; with --reference-seeds, take "
                         "only that phase's readings (train_spread, dp_spread, sp_spread)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one CUDA card",
              file=sys.stderr)
        return 2
    from ood_in_object_detection_torch.ops.kernels import _build

    t_start = time.perf_counter()
    env = phase_env(torch)
    t0 = time.perf_counter()
    builds = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=[{k: b[k] for k in ("name", "seconds")} for b in builds],
         nvcc_flags=" ".join(_build.NVCC_FLAGS))
    if args.reference_seeds and args.only == "e2e_dp":
        dp_spread(torch, args.reference_seeds)
        return 0
    if args.reference_seeds and args.only == "e2e_sp":
        sp_spread(torch, args.reference_seeds)
        return 0
    if args.reference_seeds:
        if not args.only:
            reference_spread(torch, args.reference_seeds)
        train_spread(torch, args.reference_seeds)
        return 0
    if args.only == "e2e_sp_train":
        phase_e2e_sp_train(torch, env)
        emit("done", seconds=time.perf_counter() - t_start)
        return 0
    if args.only == "e2e_train":
        rng = np.random.default_rng(SEED)
        det = family_detector(torch, MODEL, make_batches(rng, 3))
        entries = phase_e2e_train(torch, det)
        emit("done", seconds=time.perf_counter() - t_start)
        print(json.dumps({"kernels": entries, "card": env["nvidia_smi"]}), flush=True)
        return 0
    if args.only == "e2e_clusters":
        rng = np.random.default_rng(SEED)
        det = family_detector(torch, MODEL, make_batches(rng, 3))
        rng = np.random.default_rng(SEED + 20)  # e2e_sweeps' scenes
        ind = label_batches(det, make_scenes(rng, SWEEP_BATCHES))
        ood = label_batches(det, make_scenes(rng, 1), unknown_every=3)
        phase_e2e_clusters(torch, det, ind, ood)
        emit("done", seconds=time.perf_counter() - t_start)
        return 0
    if args.only == "e2e_sp":
        from ood_in_object_detection_torch.engine import Detector
        from ood_in_object_detection_torch.scripts import bench_k3 as BK3

        emit("profile_coverage", at="start", **BK3.profile_coverage())
        batches = make_batches(np.random.default_rng(SEED), 3)  # e2e's: the same run
        images = batches[2]
        det = family_detector(torch, MODEL, batches)
        det16 = Detector.create(MODEL, nc=NC, img_size=IMG, device=DEVICE, dtype=torch.bfloat16,
                                state_dict=det.model.state_dict())
        phase_e2e_sp(torch, det, det16, images, env)
        emit("profile_coverage", at="end", **BK3.profile_coverage())
        emit("done", seconds=time.perf_counter() - t_start)
        return 0
    if args.only == "e2e_dp":
        from ood_in_object_detection_torch.core.checkpoint import save_checkpoint

        rng = np.random.default_rng(SEED)
        ind_imgs, ood_imgs = make_batches(rng, 2), make_batches(rng, 1)
        det = family_detector(torch, MODEL, ind_imgs + ood_imgs)
        ind, ood = label_batches(det, ind_imgs), label_batches(det, ood_imgs, unknown_every=3)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
            root = Path(root)
            save_checkpoint(root / "v8l_serve", det.model, {"name": "v8l_serve", "nc": NC}, MODEL)
            write_dataset(root / "ind", ind)
            write_dataset(root / "ood", ood)
            phase_e2e_dp(torch, det, ind, ood, root, env)
        emit("done", seconds=time.perf_counter() - t_start)
        return 0
    det, methods, ind, ood, launches, step_ms = phase_e2e(torch)
    launches_eul, eul_parts = phase_e2e_eul(torch, det, methods["Cosine_cl_stride"], ood)
    launches_sweeps, cluster_banks, sweep_ind, sweep_ood = phase_e2e_sweeps(torch, det)
    launches_clusters, a7c_banks = phase_e2e_clusters(torch, det, sweep_ind, sweep_ood)
    cluster_banks.update(a7c_banks)
    launches_sdr, sdr_entry = phase_e2e_sdr(torch, det, sweep_ind, sweep_ood)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as serve_root:
        launches_serve = phase_e2e_serve(torch, det, ind, ood, env, Path(serve_root))
        det16, launches16, step16_ms = phase_e2e_bf16(torch, det, methods, ind, ood)
        launches_bundle = phase_e2e_bundle(torch, det, det16, Path(serve_root), env)
        launches_dp = phase_e2e_dp(torch, det, ind, ood, Path(serve_root), env)
        phase_e2e_sp_train(torch, env, Path(serve_root) / "dp_train_ref.pt")
    images = ood[0]["images"]
    launches_sp, sp_slab = phase_e2e_sp(torch, det, det16, images, env)
    phase_reference(torch, det, images)
    phase_profile(torch, det, images, step_ms)
    phase_profile(torch, det16, images, step16_ms, label="profile_bf16")
    with torch.no_grad():
        entries = phase_kernels(torch, det, det16, methods["Cosine_cl_stride"], images,
                                _added(launches, launches16, launches_eul, launches_sweeps,
                                       launches_clusters, launches_serve, launches_bundle,
                                       launches_dp, launches_sp), eul_parts,
                                cluster_banks)
    entries[-1]["sp_slab"] = sp_slab  # K4's entry: on sp 2's halo slab (e2e_sp)
    entries.append(sdr_entry)
    entries += phase_e2e_families(torch)
    entries += phase_xscale_stem(torch, images)
    entries += phase_e2e_train(torch, det)
    entries += phase_stem_parts(torch)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": entries, "card": env["nvidia_smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
