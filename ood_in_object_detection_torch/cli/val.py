"""Standalone validation CLI of the PyTorch port (the JAX package's
cli/val.py; the reference's ``yolo val``: engine/validator.py BaseValidator
and DetMetrics mAP50 / mAP50-95): load a checkpoint, predict over a dataset
split at the validator's conf 0.001 and report or write the metrics.

    python -m ood_in_object_detection_torch.cli.val --model_path runs/run \\
        --dataset data.yaml --out metrics.json --device 0

The train CLI's ``--val_only`` covers the same path inside a training run
directory; this one needs no trainer state.
"""

from __future__ import annotations

import argparse
import json
import logging
import types
from pathlib import Path

log = logging.getLogger("val")

UNPORTED_FLAGS = {
    "compile_cache": "none: the eager port compiles nothing ahead of time",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("val")
    p.add_argument("--model_path", required=True, help="checkpoint dir (core/checkpoint.py)")
    p.add_argument("--dataset", required=True, help="dataset yaml")
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--owod_task", default="",
                   choices=["", "t1", "t2", "t3", "t4", "all_task_test"])
    p.add_argument("--owod_tasks_dir", default=str(
        Path(__file__).resolve().parents[2] / "datasets_utils" / "owod" / "tasks"))
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--max_gt", type=int, default=128)
    p.add_argument("--out", default="", help="optional metrics json path")
    p.add_argument("--device", default="0",
                   help="CUDA device index, or 'cpu' for the plain PyTorch versions")
    p.add_argument("--compile_cache", default="", help="not ported")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md: {item})")

    from ..core.checkpoint import load_checkpoint
    from ..data import DetectionDataset
    from ..models import build_model
    from .ood_eval import torch_device
    from .train import validate

    device = torch_device(args.device)
    ds = DetectionDataset.from_yaml(args.dataset, split=args.split,
                                    owod_task=args.owod_task or None,
                                    tasks_dir=args.owod_tasks_dir or None)
    if not len(ds):
        raise SystemExit(f"empty {args.split} split in {args.dataset}")
    sd, meta = load_checkpoint(args.model_path)
    nc = int(meta.get("train_args", {}).get("nc", meta["nc"]))
    model = build_model(meta["model_name"], nc=nc).to(device)
    metrics = validate(model, types.SimpleNamespace(ema_params=sd), ds, args, nc)
    log.info("%s %s: mAP50=%.4f mAP50-95=%.4f", meta["model_name"], args.split,
             metrics["mAP50"], metrics["mAP50_95"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}, indent=1))
    return metrics


if __name__ == "__main__":
    main()
