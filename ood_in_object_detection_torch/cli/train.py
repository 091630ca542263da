"""Training CLI of the PyTorch port, with the flags of
``ood_in_object_detection_tpu/cli/train.py`` (reference custom_training.py:
13-207): model version and size, class-count override, OWOD task plumbing,
backbone freeze and graft, val_every gating, resume, per-epoch results.csv
and tensorboard scalars, checkpoints on the validation cadence.

    python -m ood_in_object_detection_torch.cli.train --dataset data.yaml \\
        --model l --epochs 100 --batch_size 16 --device 0

It runs on the card (``--device 0``) unless asked for the CPU (``--device
cpu``, the plain PyTorch versions of the kernels). A comma list trains data
parallel, one rank (process) per entry, as the reference's ultralytics
trainer does: ``--device 0,1,2,3`` on four cards (NCCL), ``--device 0,0``
or ``cpu,cpu`` as two gloo ranks on one card or the CPU. Each step is the
single-process run's step on the same global batch (JAX's global step:
BatchNorm statistics and the loss normalizer over it, the gradient summed
over the ranks; train/trainer.py:make_sharded_train_step): every rank
builds the same batches, in the same order, and takes its rows of each;
rank 0 alone validates and writes results.csv, the tensorboard events and
the checkpoints. ``--dtype bfloat16`` trains with f32 parameters and bf16
compute, as the JAX CLI does, without loss scaling. Validation predicts
with the EMA weights at conf 0.001 through ``Detector.predict`` (kernels
K4, K1 and K2 on the card).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import logging
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from ..utils import tb_events

log = logging.getLogger("train")

# flag -> the ROADMAP.md item that will port it
UNPORTED_FLAGS = {
    "compile_cache": "none: the eager port compiles nothing ahead of time",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train")
    p.add_argument("--model", default="l",
                   choices=["n", "s", "m", "b", "l", "x", "t", "c", "e"])
    p.add_argument("--model_version", default="yolov8",
                   choices=["yolov8", "yolov9", "yolov10", "yolo11", "yolo12",
                            # hub-pretrained families the reference offers via
                            # .pt downloads (custom_training.py:16): refused in main()
                            "yolov5", "yolov6"])
    p.add_argument("--dataset", required=True, help="dataset yaml")
    p.add_argument("--owod_task", default="", choices=["", "t1", "t2", "t3", "t4"])
    p.add_argument("--owod_tasks_dir", default=str(
        Path(__file__).resolve().parents[2] / "datasets_utils" / "owod" / "tasks"))
    p.add_argument("--number_of_classes", type=int, default=0,
                   help="override nc (reference trainer.py:158-161)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--lr0", type=float, default=0.01)
    p.add_argument("--lrf", type=float, default=0.01,
                   help="final LR = lr0 * lrf (reference custom_training.py lrf)")
    p.add_argument("--cos_lr", action="store_true",
                   help="cosine per-epoch LR instead of the linear staircase (reference cos_lr)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer's inside in the backward (torch.utils.checkpoint "
                        "at the per-layer boundaries): ~1 extra forward of work for keeping "
                        "only the layers' outputs")
    p.add_argument("--val_every", type=int, default=10)
    p.add_argument("--do_not_val_during_training", action="store_true",
                   help="skip mid-training validation entirely (reference custom_training.py "
                        "flag); checkpoints still save on the val_every cadence")
    p.add_argument("--workers", type=int, default=4,
                   help="decode threads for the batcher (reference workers)")
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--name", default="run")
    p.add_argument("--out_dir", default="runs")
    p.add_argument("--max_gt", type=int, default=128)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--no_augment", action="store_true",
                   help="disable mosaic/HSV/flip (letterbox-only batches)")
    p.add_argument("--close_mosaic", type=int, default=10)
    p.add_argument("--val_only", action="store_true",
                   help="load --model_path and validate, no training "
                        "(reference custom_training.py val-only mode)")
    p.add_argument("--model_path", default="", help="checkpoint dir for --val_only")
    p.add_argument("--resume", default="",
                   help="checkpoint dir to resume mid-training from: restores parameters, EMA, "
                        "optimizer and step and continues at the saved epoch + 1 "
                        "(reference engine/trainer.py resume)")
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--copy_paste", type=float, default=0.0)
    p.add_argument("--degrees", type=float, default=0.0)
    p.add_argument("--shear", type=float, default=0.0)
    p.add_argument("--perspective", type=float, default=0.0)
    p.add_argument("--no_tensorboard", action="store_true",
                   help="skip writing tensorboard event files to the run dir")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches whose host->device copies are kept in flight (pinned memory, "
                        "a side stream) so that the copy overlaps the previous step")
    p.add_argument("--profile", default="",
                   help="directory to write a torch.profiler trace of the first training epoch")
    p.add_argument("--pretrained_backbone", default="",
                   help="classification-model .pt whose backbone (layers 0-6) is grafted "
                        "before training (reference custom_training.py:129-133)")
    p.add_argument("--device", default="0",
                   help="CUDA device index, or 'cpu' for the plain PyTorch versions; a comma "
                        "list (0,1,2,3; 0,0; cpu,cpu) trains data parallel, one rank an entry")
    p.add_argument("--compile_cache", default="", help="not ported")
    return p


def check_ported(args) -> None:
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md: {item})")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    check_ported(args)
    from ..core.precision import disable_tf32
    from ..parallel.mesh import parse_devices

    disable_tf32()  # before spawn, which hands this process's flags to the ranks
    entries = parse_devices(args.device)
    if len(entries) == 1:
        return run(args)
    if args.val_only:
        raise SystemExit("--val_only runs on one device")
    if args.batch_size % len(entries):
        raise ValueError(f"--batch_size {args.batch_size} must divide over the "
                         f"{len(entries)} ranks of --device {args.device}")
    from ..parallel.distributed import spawn

    log.info("data-parallel training: %d ranks on %s", len(entries),
             ",".join(map(str, entries)))
    spawn(_train_rank, entries, args=(argv,))


def _train_rank(rank: int, world: int, argv) -> None:
    """One rank of a data-parallel run (parallel/distributed.py:spawn)."""
    from ..parallel.mesh import make_mesh, parse_devices

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)
    run(args, make_mesh(devices=parse_devices(args.device)), rank)


def run(args, mesh=None, rank: int = 0) -> None:
    """The training run of ``args`` in this process: as rank ``rank`` of
    ``mesh`` (one rank per entry, the process group up), or on a mesh of
    ``--device`` alone, as the JAX CLI always trains on a mesh."""
    from ..core.checkpoint import load_checkpoint, restore_train_state, save_checkpoint
    from ..data import DetectionDataset, PaddedBatcher
    from ..models import build_model, init_weights
    from ..parallel.mesh import make_mesh, prefetch_to_device
    from ..train.trainer import (TrainConfig, backbone_freeze_prefixes, init_state,
                                 lr_schedule, make_sharded_train_step, shard_state)
    from .factory import resolve_model_name
    from .ood_eval import torch_device

    if args.model_version in ("yolov5", "yolov6"):
        raise SystemExit(
            f"{args.model_version}: the reference trains these only from "
            "hub-pretrained .pt downloads (custom_training.py:16,31); this "
            "rebuild has no network access and no v5/v6 graph specs — "
            "hub-pretrained models are unavailable (see PARITY.md N/A list).")
    mesh = mesh or make_mesh(devices=[torch_device(args.device)])
    device = mesh.batch_devices[rank]
    lead = rank == 0  # validates and writes
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    ds = DetectionDataset.from_yaml(args.dataset, split="train",
                                    owod_task=args.owod_task or None,
                                    tasks_dir=args.owod_tasks_dir or None)
    nc = args.number_of_classes or ds.number_of_classes
    name = resolve_model_name(args.model_version, args.model)

    if args.no_augment:
        batcher = PaddedBatcher(ds, args.batch_size, args.img_size,
                                max_gt=args.max_gt, workers=args.workers)
    else:
        from ..data.augment import AugmentConfig, AugmentedTrainBatcher

        batcher = AugmentedTrainBatcher(
            ds, args.batch_size, args.img_size, max_gt=args.max_gt,
            cfg=AugmentConfig(close_mosaic=args.close_mosaic, mixup=args.mixup,
                              copy_paste=args.copy_paste, degrees=args.degrees,
                              shear=args.shear, perspective=args.perspective),
            epochs=args.epochs, workers=args.workers)
    steps_per_epoch = max(len(batcher), 1)
    model = build_model(name, nc=nc, dtype=dtype)
    freeze = backbone_freeze_prefixes(model.spec) if args.freeze_backbone else ()
    cfg = TrainConfig(lr0=args.lr0, lrf=args.lrf, cos_lr=args.cos_lr,
                      epochs=args.epochs, steps_per_epoch=steps_per_epoch,
                      freeze_prefixes=freeze, remat=args.remat)

    # validation split (reference validates every val_every epochs,
    # engine/trainer.py:441-445)
    try:
        val_ds = DetectionDataset.from_yaml(args.dataset, split="val",
                                            owod_task=args.owod_task or None,
                                            tasks_dir=args.owod_tasks_dir or None)
    except Exception:
        val_ds = None

    if args.val_only:
        if not args.model_path:
            raise SystemExit("--val_only requires --model_path")
        if val_ds is None or not len(val_ds):
            raise SystemExit("no validation split found")
        sd, meta = load_checkpoint(args.model_path)
        vnc = int(meta.get("train_args", {}).get("nc", meta["nc"]))
        vmodel = build_model(meta["model_name"], nc=vnc).to(device)
        metrics = validate(vmodel, types.SimpleNamespace(ema_params=sd), val_ds, args, vnc)
        log.info("val-only: mAP50=%.4f mAP50-95=%.4f", metrics["mAP50"], metrics["mAP50_95"])
        return

    start_epoch = 0
    if args.resume:
        model.to(device)
        state, meta = restore_train_state(args.resume, model, cfg)
        start_epoch = int(meta.get("epoch", -1)) + 1
        log.info("resumed %s at epoch %d (step %d)", args.resume, start_epoch, state.step)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
        if args.pretrained_backbone:
            from ..utils.weights import graft_classification_backbone

            grafted = graft_classification_backbone(model, args.pretrained_backbone)
            log.info("grafted %d backbone tensors from %s", grafted, args.pretrained_backbone)
        state = init_state(model.to(device), cfg)
    state = shard_state(state, mesh)
    step = make_sharded_train_step(model, cfg, mesh)
    if hasattr(batcher, "epoch"):
        batcher.epoch = start_epoch  # keep close_mosaic aligned on resume
    lr_fn = lr_schedule(cfg)
    run_dir = Path(args.out_dir) / args.name
    csv_path = run_dir / "results.csv"
    if lead:
        run_dir.mkdir(parents=True, exist_ok=True)
    if lead and (not csv_path.exists() or start_epoch == 0):
        # per-epoch training curve (reference utils/callbacks writes
        # results.csv + tensorboard scalars; the CSV is the durable artifact)
        csv_path.write_text("epoch,time_s,train/box_loss,train/cls_loss,"
                            "train/dfl_loss,train/total_loss,lr,"
                            "metrics/mAP50,metrics/mAP50-95\n")
    # tensorboard events beside the CSV (reference callbacks/tensorboard.py:
    # 8-97), written without importing tensorboard
    tb = tb_events.EventWriter(run_dir) if lead and not args.no_tensorboard else None
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.perf_counter()
            losses = []
            prof_ctx = contextlib.nullcontext()
            profile = lead and args.profile and epoch == start_epoch
            if profile:
                from ..utils.profiling import trace

                prof_ctx = trace(args.profile)
            with prof_ctx:  # the trace is written even if a step raises
                for placed in prefetch_to_device(batcher, mesh, size=args.prefetch):
                    state, lb = step(state, placed)
                    losses.append(lb)
            if profile:
                log.info("profiler trace written to %s", args.profile)
            mean = {k: float(torch.stack([getattr(lb, k) for lb in losses]).mean())
                    for k in ("total", "box", "cls", "dfl")}
            dt = time.perf_counter() - t0
            log.info("epoch %d: loss=%.4f (%.1fs)", epoch, mean["total"], dt)
            map50 = map5095 = float("nan")
            if not lead:
                continue
            if (epoch + 1) % max(args.val_every, 1) == 0 or epoch == args.epochs - 1:
                if val_ds is not None and len(val_ds) and not args.do_not_val_during_training:
                    metrics = validate(model, state, val_ds, args, nc)
                    map50, map5095 = metrics["mAP50"], metrics["mAP50_95"]
                    log.info("epoch %d val: mAP50=%.4f mAP50-95=%.4f", epoch, map50, map5095)
                save_checkpoint(run_dir, state,
                                train_args={"name": args.name, "nc": nc, **vars(args)},
                                model_name=name, epoch=epoch)
            lr_now = float(lr_fn((epoch + 1) * steps_per_epoch))
            with csv_path.open("a") as f:
                f.write(f"{epoch},{dt:.2f},{mean['box']:.6f},{mean['cls']:.6f},"
                        f"{mean['dfl']:.6f},{mean['total']:.6f},{lr_now:.6g},"
                        f"{map50:.6f},{map5095:.6f}\n")
            if tb is not None:
                tb.scalars({"train/box_loss": mean["box"],
                            "train/cls_loss": mean["cls"],
                            "train/dfl_loss": mean["dfl"],
                            "train/total_loss": mean["total"],
                            "lr/lr0": lr_now,
                            "metrics/mAP50(B)": map50,
                            "metrics/mAP50-95(B)": map5095}, epoch)
                tb.flush()
    finally:
        # flush even on a mid-training failure (the bytes buffered since the
        # last per-epoch flush would otherwise be lost)
        if tb is not None:
            tb.close()
    log.info("done")


def validate(model, state, val_ds, args, nc):
    """Detection validation with the EMA weights (reference validator and
    DetMetrics, eval/det_metrics.py): a Detector on a copy of ``model``
    holding ``state.ema_params`` (a state_dict, BatchNorm statistics
    included: a TrainState's, or a checkpoint's weights), predicting at
    conf 0.001 (K4, K1 and K2 on the card)."""
    from ..data import PaddedBatcher
    from ..engine import Detector
    from ..eval.det_metrics import compute_det_metrics

    vmodel = copy.deepcopy(model)
    vmodel.load_state_dict(state.ema_params)
    vmodel.remat = False
    for p in vmodel.parameters():
        p.grad = None
    det = Detector(model=vmodel.eval(), img_size=args.img_size)
    preds, targets = [], []
    for batch in PaddedBatcher(val_ds, args.batch_size, args.img_size, max_gt=args.max_gt,
                               workers=getattr(args, "workers", 4)):
        out = det.predict(batch["images"], conf_thres=0.001)
        boxes, conf = out.det.boxes.cpu().numpy(), out.det.conf.cpu().numpy()
        cls, valid = out.det.cls.cpu().numpy(), out.det.valid.cpu().numpy()
        bmask = batch.get("batch_mask", np.ones(len(boxes), bool))
        for i in range(len(boxes)):
            if not bmask[i]:
                continue
            n = int(valid[i].sum())
            preds.append(dict(img_name=batch["im_names"][i], bboxes=boxes[i, :n],
                              cls=cls[i, :n], conf=conf[i, :n]))
            m = batch["gt_mask"][i]
            targets.append(dict(img_name=batch["im_names"][i],
                                bboxes=batch["gt_bboxes"][i][m],
                                cls=batch["gt_labels"][i][m]))
    return compute_det_metrics(preds, targets, nc)


if __name__ == "__main__":
    main()
