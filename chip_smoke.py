#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure anywhere raises, and the
script exits non-zero without printing a result):

1. env: torch / CUDA versions, the card's name and power limit (the raw
   ``nvidia-smi --query-gpu=name,power.limit`` line is printed on its own),
   TF32 switched off for matmuls and cuDNN convolutions.
2. build: compile the three CUDA kernels from ``csrc/`` with nvcc.
3. e2e: yolov8l at 640 px, nc=20, seeded random weights (BatchNorm
   statistics calibrated on the run's images, the head's output convs
   spread from a numpy seed), batches of 8 seeded uint8 images. Ground truth
   comes from the model's own first predict pass. Extract -> fit -> evaluate
   for MSP and Cosine_cl_stride; the kernels' launch counters are reset just
   before and read just after, and every kernel must have launched.
4. reference: one image through the card (kernels) and through the CPU
   (plain PyTorch versions) with the same weights; maps, detections and
   taps must agree.
5. profile: device time of the predict step by kernel (torch.profiler).
6. kernels: each kernel against its plain PyTorch version on the card, on
   tensors captured from the main path (plus a controlled NMS case and a
   K=5 centroid bank with empty groups), with times from CUDA events.

The last lines are the ``{"kernels": [...]}`` object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
MODEL = "yolov8l"  # the paper's flagship model
BATCH = 8
IMG = 640
NC = 20
DEVICE = "cuda"
CONF = 0.15  # the CLI's conf_thr_train / conf_thr_test defaults
OWOD_KEYS = {"mAP", "U-AP", "U-F1", "U-PRE", "U-REC", "A-OSE", "WI-08"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


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
                        im_names=[f"b{bi}_{i}" for i in range(BATCH)]))
    return out


def phase_e2e(torch):
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.ood import distance as D
    from ood_in_object_detection_torch.ood.methods import DistanceOODMethod, LogitsOODMethod
    from ood_in_object_detection_torch.ood.pipeline import (evaluate_method,
                                                            extract_ind_activations,
                                                            fit_ind_pipeline)
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops import roi_align as R
    from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm,
                                                             load_jax_variables,
                                                             numpy_state_dict, spread_detect_head)

    rng = np.random.default_rng(SEED)
    ind_imgs, ood_imgs = make_batches(rng, 2), make_batches(rng, 1)
    det = Detector.create(MODEL, nc=NC, img_size=IMG, device=DEVICE,
                          generator=torch.Generator().manual_seed(SEED))
    calib = torch.from_numpy(np.concatenate(ind_imgs + ood_imgs)).to(DEVICE)
    calibrate_batchnorm(det.model, calib.permute(0, 3, 1, 2).float() * (1.0 / 255.0))
    del calib
    load_jax_variables(det.model, spread_detect_head(numpy_state_dict(det.model), seed=SEED + 1))

    ind = label_batches(det, ind_imgs)
    ood = label_batches(det, ood_imgs, unknown_every=3)
    known, names = list(range(NC)), [f"c{k}" for k in range(NC)] + ["unknown"]

    kernels = (N.greedy_keep, R.roi_contract, D.min_group_distances)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    results = {}
    methods = {"MSP": LogitsOODMethod("MSP"),
               "Cosine_cl_stride": DistanceOODMethod.from_name("Cosine_cl_stride")}
    for name, m in methods.items():
        acts = extract_ind_activations(det, ind, m, conf_thr_train=CONF)
        fit_ind_pipeline(m, acts, tpr=0.95)
        results[name] = evaluate_method(det, ood, m, known, names, conf_thr_test=CONF)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}

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
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    out = det.predict(ood_imgs[0], conf_thres=CONF)
    for t in (out.det.boxes, out.det.conf, out.logits, out.roi_feats, out.exact_feats):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite predict output")
    step_ms = cuda_ms(lambda: det.predict(ood_imgs[0], conf_thres=CONF), reps=10)
    x = torch.from_numpy(ood_imgs[0]).to(DEVICE).permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: det.model(x.contiguous()), reps=10)
    emit("e2e", model=MODEL, img_size=IMG, nc=NC, batch=BATCH, seconds=seconds,
         launches=launches, metrics=results, clusters=n_clusters,
         thresholds={k: m.thresholds for k, m in methods.items()},
         detections_per_image=float(out.det.valid.sum(1).float().mean()),
         predict_step_ms=step_ms, model_forward_ms=forward_ms,
         images_per_s=BATCH * 1000.0 / step_ms)
    return det, methods["Cosine_cl_stride"], ood_imgs[0], launches, step_ms


def phase_reference(torch, det, images):
    """The card's kernel path against the CPU's plain path, one image."""
    import copy

    from ood_in_object_detection_torch.engine import Detector

    cpu = Detector(model=copy.deepcopy(det.model).cpu(), img_size=det.img_size)
    img = images[:1]
    g, c = det.predict(img, conf_thres=CONF), cpu.predict(img, conf_thres=CONF)
    with torch.no_grad():
        x = torch.from_numpy(img).float().permute(0, 3, 1, 2) * (1.0 / 255.0)
        raw_g, _ = det.model(x.to(DEVICE))
        raw_c, _ = cpu.model(x)
    map_err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(raw_g, raw_c))
    ga, ca = g.anchor_idx[0][g.det.valid[0]].cpu(), c.anchor_idx[0][c.det.valid[0]]
    common = np.intersect1d(ga.numpy(), ca.numpy())
    if len(common) == 0:
        raise AssertionError("card and CPU share no detection on the reference image")
    overlap = len(common) / len(ca)
    gi = {int(a): i for i, a in enumerate(ga)}
    ci = {int(a): i for i, a in enumerate(ca)}
    rows_g = torch.tensor([gi[int(a)] for a in common])
    rows_c = torch.tensor([ci[int(a)] for a in common])
    box_err = float((g.det.boxes[0, rows_g].cpu() - c.det.boxes[0, rows_c]).abs().max())
    cls_equal = bool(torch.equal(g.det.cls[0, rows_g].cpu(), c.det.cls[0, rows_c]))
    roi_err, exact_err = (float((a[0, rows_g].cpu() - b[0, rows_c]).abs().max() / b.abs().max())
                          for a, b in ((g.roi_feats, c.roi_feats), (g.exact_feats, c.exact_feats)))
    emit("reference", detections_card=len(ga), detections_cpu=len(ca), overlap=overlap,
         raw_map_rel_err=map_err, box_abs_err_px=box_err, cls_equal=cls_equal,
         roi_feat_rel_err=roi_err, exact_feat_rel_err=exact_err)
    # cuDNN's f32 convolution algorithms and the CPU's sum in other orders
    # (2.4e-4 of the map's scale measured on an H100), so a detection may
    # cross a threshold: the sets agree up to 2 % and matched rows closely.
    # A box edge that moved by box_err px also moves its RoI window, so RoI
    # features get 1e-2 of the scale; the exact (anchor-cell) tap does not move.
    if not (map_err < 1e-3 and overlap > 0.98 and cls_equal and box_err < 1.0
            and roi_err < 1e-2 and exact_err < 1e-3):
        raise AssertionError("card and CPU disagree on the reference image")


def phase_profile(torch, det, images, step_ms: float, steps: int = 3):
    """Device time of the predict step by kernel (torch.profiler / CUPTI),
    and its share of the step's CUDA-event time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    det.predict(images, conf_thres=CONF)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            det.predict(images, conf_thres=CONF)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / steps, e.key, e.count / steps)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    device_us = sum(r[0] for r in rows)
    emit("profile", steps=steps, kernels_per_step=sum(r[2] for r in rows),
         device_us_per_step=device_us if rows else "not measured",
         device_busy_share=device_us / (step_ms * 1000.0) if rows else "not measured",
         top=[{"name": k[:90], "us_per_step": t, "calls_per_step": c} for t, k, c in rows[:15]])


def phase_kernels(torch, det, dist_method, images, launches):
    from ood_in_object_detection_torch.ood import distance as D
    from ood_in_object_detection_torch.ood.pipeline import distance_features
    from ood_in_object_detection_torch.ops import nms as N
    from ood_in_object_detection_torch.ops import roi_align as R
    from ood_in_object_detection_torch.ops.fused_detect import select_candidates

    x = torch.from_numpy(images).to(DEVICE).permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    with torch.no_grad():
        raw, _ = det.model(x.contiguous())
    cand = select_candidates(raw, det.nc, CONF, pre_nms_k=1024)
    shifted, valid = N.nms_inputs(cand.boxes, cand.conf, cand.cls,
                                  torch.tensor(CONF, device=DEVICE))
    out = det.predict(images, conf_thres=CONF)
    entries = []

    # K1: the main path's (8, 1024) candidates, and controlled boxes at k=1024
    crng = np.random.default_rng(SEED + 2)
    centres = crng.uniform(20, 600, (BATCH, 257, 2))
    pick = crng.integers(0, 257, (BATCH, 1024))
    c = np.take_along_axis(centres, pick[..., None], 1) + crng.normal(0, 4, (BATCH, 1024, 2))
    wh = crng.uniform(20, 120, (BATCH, 1024, 2))
    ctrl = torch.tensor(np.concatenate([c - wh / 2, c + wh / 2], -1), dtype=torch.float32,
                        device=DEVICE)
    ctrl_valid = torch.tensor(crng.uniform(size=(BATCH, 1024)) > 0.1, device=DEVICE)
    cases = {"main_path": (shifted, valid), "controlled": (ctrl, ctrl_valid)}
    mism, err = 0, 0.0
    for label, (b, v) in cases.items():
        got = N.greedy_keep(b, v, 0.7)
        ref = N.greedy_keep_plain(b, v, 0.7)
        mism += int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
        emit("kernel_case", kernel="nms_keep", case=label, shape=list(b.shape),
             kept=int(got.sum()), valid=int(v.sum()), mismatches=int((got != ref).sum()))
    if mism:
        raise AssertionError(f"nms_keep: {mism} keep-mask entries differ from the plain version")
    entries.append(dict(name="nms_keep", route="cuda",
                        source="ood_in_object_detection_torch/csrc/nms_keep.cu",
                        replaces="ood_in_object_detection_tpu/ops/pallas/nms.py:65",
                        launches=launches["greedy_keep"], max_abs_err=err,
                        ms=cuda_ms(lambda: N.greedy_keep(shifted, valid, 0.7)),
                        plain_ms=cuda_ms(lambda: N.greedy_keep_plain(shifted, valid, 0.7))))

    # K2: every level's map with the real RoI + exact-tap axis weights
    level_args, err, off = [], 0.0, 0
    for f in out.neck:
        _, h, w, _ = f.shape
        wx, wy = R.level_axis_weights((h, w), out.det.boxes, out.anchor_idx, out.stride_level,
                                      len(level_args), off, IMG, 0)
        off += h * w
        got, ref = R.roi_contract(f, wx, wy), R.roi_contract_plain(f, wx, wy)
        e = float((got - ref).abs().max() / ref.abs().max())
        err = max(err, float((got - ref).abs().max()))
        emit("kernel_case", kernel="roi_contract", case=f"level_{h}x{w}", shape=list(f.shape),
             rows=wx.shape[1], rel_err=e)
        if e > 1e-5:
            raise AssertionError(f"roi_contract level {h}x{w}: rel err {e} > 1e-5")
        level_args.append((f, wx, wy))
    entries.append(dict(name="roi_contract", route="cuda",
                        source="ood_in_object_detection_torch/csrc/roi_contract.cu",
                        replaces="ood_in_object_detection_tpu/ops/pallas/roi.py:113",
                        launches=launches["roi_contract"], max_abs_err=err,
                        ms=cuda_ms(lambda: [R.roi_contract(*a) for a in level_args]),
                        plain_ms=cuda_ms(lambda: [R.roi_contract_plain(*a) for a in level_args])))

    # K3: the real features against the fitted bank; a K=5 bank with empty
    # groups for cosine and l2. L2 near 0 is sqrt of a cancelled difference
    # (~1e-7 in the square -> ~3e-4 after the root), hence its atol 1e-3.
    feats, groups, kmask = dist_method.group_inputs(
        distance_features(dist_method, out, det.neck_channels())[0])
    ng, dd = groups.shape[0], groups.shape[2]
    brng = np.random.default_rng(SEED + 3)
    k5 = D.l2_normalize_rows(torch.tensor(brng.normal(size=(ng, 5, dd)), dtype=torch.float32,
                                          device=DEVICE))
    k5mask = torch.tensor(brng.uniform(size=(ng, 5)) > 0.3, device=DEVICE)
    k5mask[::7] = False
    cases = [("fitted_bank", "cosine", feats, groups, kmask),
             ("k5_bank", "cosine", feats, k5, k5mask), ("k5_bank", "l2", feats, k5, k5mask)]
    err = 0.0
    for label, metric, xf, cg, km in cases:
        got = D.min_group_distances(xf, cg, km, metric)
        ref = D.min_group_distances_plain(xf, cg, km, metric)
        fin = torch.isfinite(ref)
        if not torch.equal(torch.isinf(got), torch.isinf(ref)):
            raise AssertionError(f"min_group_distance {label}/{metric}: empty groups differ")
        e = float((got[fin] - ref[fin]).abs().max())
        err = max(err, e)
        emit("kernel_case", kernel="min_group_distance", case=f"{label}_{metric}",
             shape=[xf.shape[0], cg.shape[0], cg.shape[1], cg.shape[2]],
             empty_groups=int((~km.any(1)).sum()), max_abs_err=e)
        if e > (1e-3 if metric == "l2" else 1e-5):
            raise AssertionError(f"min_group_distance {label}/{metric}: err {e}")
    entries.append(dict(name="min_group_distance", route="cuda",
                        source="ood_in_object_detection_torch/csrc/min_group_distance.cu",
                        replaces="ood_in_object_detection_tpu/ops/pallas/distance.py:59",
                        launches=launches["min_group_distances"], max_abs_err=err,
                        ms=cuda_ms(lambda: D.min_group_distances(feats, groups, kmask, "cosine")),
                        plain_ms=cuda_ms(lambda: D.min_group_distances_plain(
                            feats, groups, kmask, "cosine"))))
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one CUDA card",
              file=sys.stderr)
        return 2
    from ood_in_object_detection_torch.ops.kernels import _build

    env = phase_env(torch)
    t0 = time.perf_counter()
    builds = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels=[{k: b[k] for k in ("name", "seconds")} for b in builds],
         nvcc_flags=" ".join(_build.NVCC_FLAGS))
    det, dist_method, images, launches, step_ms = phase_e2e(torch)
    phase_reference(torch, det, images)
    phase_profile(torch, det, images, step_ms)
    entries = phase_kernels(torch, det, dist_method, images, launches)
    print(json.dumps({"kernels": entries, "card": env["nvidia_smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
