"""Offline activation-dataset dump (port of
ood_in_object_detection_tpu/cli/extract_activations.py; reference
create_dataset_of_activations.py + ActivationsExtractor, ood_utils.py:2599-2758):
iterate a dataset, run the predict step, and pickle the matched boxes'
per-class logits and/or per-(class, stride) RoI features for later analysis
and embedding plots (``cli/embedding_plot.py``). The payload is the JAX
CLI's: ``{"logits": [class] -> (N, nc), "roi_feats": [class][stride] ->
(N, C_stride)}``.

    python -m ood_in_object_detection_torch.cli.extract_activations \\
        --dataset ind.yaml --out acts.pkl --device 0
"""

from __future__ import annotations

import argparse
import logging
import pickle
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser("extract_activations")
    p.add_argument("--model", default="n")
    p.add_argument("--model_version", default="yolov8")
    p.add_argument("--model_path", default="")
    p.add_argument("--device", default="0",
                   help="CUDA device index, or 'cpu' for the plain PyTorch versions")
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--owod_task", default="")
    p.add_argument("--owod_tasks_dir", default="")
    p.add_argument("--which", default="both", choices=["logits", "roi_feats", "both"])
    p.add_argument("--conf_thr", type=float, default=0.15)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..data import DetectionDataset, PaddedBatcher
    from ..ood.methods import DistanceOODMethod, FusionOODMethod, LogitsOODMethod
    from ..ood.pipeline import extract_ind_activations
    from .ood_eval import load_detector

    args.owod_task_ind = args.owod_task
    detector = load_detector(args)
    ds = DetectionDataset.from_yaml(args.dataset, split=args.split,
                                    owod_task=args.owod_task or None,
                                    tasks_dir=args.owod_tasks_dir or None)
    batches = PaddedBatcher(ds, args.batch_size, args.img_size)

    methods = []
    if args.which in ("logits", "both"):
        methods.append(LogitsOODMethod("MSP"))
    if args.which in ("roi_feats", "both"):
        methods.append(DistanceOODMethod.from_name("Cosine_cl_stride"))
    holder = methods[0] if len(methods) == 1 else FusionOODMethod(methods, "and")
    acts = extract_ind_activations(detector, batches, holder, args.conf_thr)
    payload = {}
    for m in methods:
        key = "logits" if isinstance(m, LogitsOODMethod) else "roi_feats"
        payload[key] = acts[id(m)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_bytes(pickle.dumps(payload))
    logging.info("wrote %s", args.out)
    return payload


if __name__ == "__main__":
    main()
