"""Inference CLI of the PyTorch port: detections with per-box InD/OoD
verdicts (port of ood_in_object_detection_tpu/cli/predict.py, the
reference's `yolo predict`: letterbox, forward, NMS, boxes mapped back to the
source pixels, ``Results`` saved as images, txt and JSON).

Sources are image files, directories or globs. Each group of
``--batch_size`` images is letterboxed, the last group zero-padded up to the
batch, and run as one predict step (``engine.Detector.predict``: K4, K1 and
K2 on the card; with ``--data_parallel`` ``Detector.predict_sharded`` over
a mesh, as ``cli.ood_eval`` builds it); a fitted OoD method (``--ood_method`` with the artifacts a
``cli.ood_eval`` run writes) adds a verdict per box (K3 for the distance
methods). The outputs keep the JAX CLI's formats: ``<stem>_pred.jpg``,
``<stem>.txt`` (``cls cx cy w h conf`` normalized to the source image, a
trailing 1 = InD / 0 = OoD with a method) and ``predictions.json``.

Model sources:
- ``--model_path``    a checkpoint directory (core/checkpoint.py)
- ``--torch_weights`` an ultralytics-named ``.pt`` (utils/weights.py:
  state_dict_from_torch_file), loaded by name, the class count read from
  the class tower's last bias
- neither: seeded random weights (smoke/demo only; a warning is printed)

    python -m ood_in_object_detection_torch.cli.predict --source imgs/ \\
        --model_path runs/ckpt --save_json --device 0
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .. import constants as C
from .factory import resolve_model_name
from .ood_eval import data_parallel_mesh, torch_device

log = logging.getLogger("predict")

IMG_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}

# flag -> the ROADMAP.md item that will port it
UNPORTED_FLAGS = {
    "compile_cache": "none: the eager port compiles nothing ahead of time",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("predict", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", nargs="+", required=True,
                   help="image file(s), directory, or glob")
    p.add_argument("--model_path", default="", help="checkpoint dir (core/checkpoint.py)")
    p.add_argument("--torch_weights", default="",
                   help="ultralytics-named .pt to load (reference checkpoints)")
    p.add_argument("--model", default="n", choices=["n", "s", "m", "l", "x", "t", "c", "e", "b"])
    p.add_argument("--model_version", default="yolov8",
                   choices=["yolov8", "yolov9", "yolov10", "yolo11", "yolo12"])
    p.add_argument("--nc", type=int, default=80,
                   help="class count when not carried by a checkpoint")
    p.add_argument("--device", default="0",
                   help="CUDA device index, or 'cpu' for the plain PyTorch versions; with "
                        "--data_parallel a comma list names the mesh's entries (0,1 or cpu,cpu)")
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.7)  # ultralytics default.yaml:57
    p.add_argument("--max_det", type=int, default=300)
    p.add_argument("--save_dir", default="runs/predict")
    p.add_argument("--no_save", action="store_true", help="skip writing annotated images")
    p.add_argument("--save_txt", action="store_true",
                   help="YOLO-format txt per image: cls cx cy w h conf "
                        "(normalized to the source image)")
    p.add_argument("--save_json", action="store_true",
                   help="one predictions.json with every detection")
    p.add_argument("--names", default="",
                   help="dataset yaml whose `names` map labels the classes")
    p.add_argument("--ood_method", default="",
                   help="fitted OoD method for per-box verdicts (method name or "
                        "fusion-M1-M2[-M3]; needs --ood_thresholds from a cli.ood_eval run)")
    p.add_argument("--ood_thresholds", default="",
                   help="*_thresholds.pkl written by cli.ood_eval")
    p.add_argument("--ood_clusters", default="",
                   help="*_clusters.pkl written by cli.ood_eval (distance methods)")
    p.add_argument("--fusion_strategy", default="none", choices=["and", "or", "score", "none"])
    # fit-time method config (must match the cli.ood_eval run that wrote the
    # pkl artifacts; a *_thresholds.json sidecar written by that run, when
    # present next to --ood_thresholds, overrides these)
    p.add_argument("--temperature_energy", type=float, default=1.0)
    p.add_argument("--temperature_odin", type=float, default=1000.0)
    p.add_argument("--use_values_before_sigmoid", action="store_true", default=True)
    p.add_argument("--no_use_values_before_sigmoid", dest="use_values_before_sigmoid",
                   action="store_false")
    p.add_argument("--which_internal_activations", default="roi_aligned_ftmaps",
                   choices=C.INTERNAL_ACTIVATIONS_EXTRACTION_OPTIONS)
    p.add_argument("--ind_info_creation_option", default="valid_preds_one_stride",
                   choices=C.IND_INFO_CREATION_OPTIONS)
    p.add_argument("--cluster_method", default="one")
    p.add_argument("--cluster_optimization_metric", default="silhouette")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard each predict batch over a mesh: every visible card (--device's "
                        "first) or --device's comma list; --batch_size must divide over it")
    p.add_argument("--compile_cache", default="", help="not ported")
    return p


def check_ported(args) -> None:
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md: {item})")


def collect_sources(sources) -> list:
    paths = []
    for s in sources:
        sp = Path(s)
        if sp.is_dir():
            paths += sorted(q for q in sp.iterdir() if q.suffix.lower() in IMG_SUFFIXES)
        elif sp.is_file():
            paths.append(sp)
        else:  # glob pattern (absolute or relative)
            import glob as globmod

            paths += sorted(Path(q) for q in globmod.glob(s)
                            if Path(q).suffix.lower() in IMG_SUFFIXES)
    if not paths:
        raise FileNotFoundError(f"no images found under {sources!r}")
    return paths


def load_class_names(args, nc: int) -> list:
    if args.names:
        import yaml as pyyaml

        spec = pyyaml.safe_load(Path(args.names).read_text())
        names = spec.get("names", {})
        if isinstance(names, dict):
            return [str(names.get(i, f"cls{i}")) for i in range(nc)]
        return [str(n) for n in names][:nc] + [f"cls{i}" for i in range(len(names), nc)]
    return [f"cls{i}" for i in range(nc)]


def build_detector(args):
    """-> (Detector, nc). Checkpoint metadata wins over the CLI's model flags."""
    from ..engine import Detector

    device = torch_device(args.device)
    if args.model_path:
        from ..core.checkpoint import load_checkpoint

        sd, meta = load_checkpoint(args.model_path)
        nc = int(meta.get("nc") or meta.get("train_args", {}).get("nc") or args.nc)
        return Detector.create(meta["model_name"], nc=nc, img_size=args.img_size,
                               device=device, state_dict=sd), nc
    name = resolve_model_name(args.model_version, args.model)
    if args.torch_weights:
        from ..utils.weights import class_count, load_torch_state_dict, state_dict_from_torch_file

        sd = state_dict_from_torch_file(args.torch_weights)
        try:  # the class count from the class tower's last bias
            nc = class_count(sd)
        except KeyError:
            nc = args.nc
        det = Detector.create(name, nc=nc, img_size=args.img_size, device=device)
        load_torch_state_dict(det.model, sd, strict=False)
        return det, nc
    log.warning("no --model_path/--torch_weights: using RANDOM weights (demo only)")
    return Detector.create(name, nc=args.nc, img_size=args.img_size, device=device), args.nc


def load_ood_method(args):
    """Rebuild a FITTED OoD method from the pkl artifacts a cli.ood_eval run
    writes (configure_ind's cache files): thresholds (and clusters for the
    distance methods) are assigned per leaf in factory order. The fit-time
    config sidecar (*_thresholds.json, written next to the pkl) is
    authoritative for temperatures, sigmoid space and the activation tap:
    fitted thresholds hold only on the score distribution they were fitted
    on. An SDR method raises ValueError: its embedder is fitted in the
    process and the artifacts do not hold it (JAX cli/predict.py:231-239)."""
    if not args.ood_method:
        return None
    import pickle

    from ..ood.methods import DistanceOODMethod
    from ..ood.pipeline import assign_fitted_state
    from .factory import build_ood_method

    if not args.ood_thresholds:
        raise ValueError("--ood_method needs --ood_thresholds (a cli.ood_eval run's "
                         "*_thresholds.pkl)")
    cfg = dict(
        ood_method=args.ood_method, cluster_method=args.cluster_method,
        cluster_optimization_metric=args.cluster_optimization_metric,
        fusion_strategy=args.fusion_strategy,
        temperature_energy=args.temperature_energy,
        temperature_odin=args.temperature_odin,
        use_values_before_sigmoid=args.use_values_before_sigmoid,
        which_internal_activations=args.which_internal_activations,
        ind_info_creation_option=args.ind_info_creation_option)
    sidecar = Path(args.ood_thresholds).with_suffix(".json")
    if sidecar.exists():
        stored = json.loads(sidecar.read_text())
        if stored.get("ood_method", args.ood_method) != args.ood_method:
            raise ValueError(f"--ood_method {args.ood_method} but {sidecar} records the "
                             f"artifacts were fitted for {stored['ood_method']}")
        drift = {k: (cfg[k], v) for k, v in stored.items() if k in cfg and cfg[k] != v}
        cfg.update({k: v for k, v in stored.items() if k in cfg})
        if drift:
            log.info("fit-time config from %s overrides flags: %s", sidecar.name, drift)
    else:
        log.warning("no fit-config sidecar next to %s: trusting the CLI flags to match the "
                    "fit-time method config", args.ood_thresholds)
    method = build_ood_method(
        cfg["ood_method"], cfg["cluster_method"], cfg["cluster_optimization_metric"],
        fusion_strategy=cfg["fusion_strategy"],
        temperature_energy=cfg["temperature_energy"],
        temperature_odin=cfg["temperature_odin"],
        use_values_before_sigmoid=cfg["use_values_before_sigmoid"])
    # the artifacts are pickles this package's cli.ood_eval wrote
    thr = pickle.loads(Path(args.ood_thresholds).read_bytes())
    clusters = pickle.loads(Path(args.ood_clusters).read_bytes()) if args.ood_clusters else None
    for m in assign_fitted_state(method, thresholds=thr, clusters=clusters):
        if isinstance(m, DistanceOODMethod):
            if m.transform_fn is not None:
                # the pkl artifacts hold clusters in the embedded space but
                # not the embedder: raw-feature distances to them mean nothing
                raise ValueError(f"{m.name} uses a fitted SDR embedding that cannot be "
                                 "restored from pkl artifacts; re-fit in-process via "
                                 "cli.ood_eval (or serve a non-SDR method)")
            m.ind_info_creation_option = cfg["ind_info_creation_option"]
            if cfg["which_internal_activations"] in C.FTMAPS_RELATED_OPTIONS:
                m.which_internal_activations = cfg["which_internal_activations"]
            if not m.clusters:
                raise ValueError(f"distance method {m.name} needs --ood_clusters with "
                                 "fitted centroids")
    return method


def letterbox_group(paths, img_size: int, batch_size: int):
    """-> (the batch (batch_size, S, S, 3) uint8 with the group's letterboxed
    images first and zeros after, ratio_pads, source (h, w)s, source images)."""
    from PIL import Image

    from ..data.letterbox import letterbox_np

    batch = np.zeros((batch_size, img_size, img_size, 3), np.uint8)
    pads, origs, raw = [], [], []
    for i, p in enumerate(paths):
        im = np.asarray(Image.open(p).convert("RGB"))
        raw.append(im)
        batch[i], ratio_pad = letterbox_np(im, (img_size, img_size))
        pads.append(ratio_pad)
        origs.append(im.shape[:2])
    return batch, pads, origs, raw


def main(argv=None) -> list:
    """Predict every source image; -> the JSON records (also written with
    --save_json)."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    logging.basicConfig(level=logging.INFO)
    mesh = data_parallel_mesh(args)
    from PIL import Image

    from ..data.letterbox import scale_boxes_back
    from ..ood.pipeline import _decisions_for_method, _np, _predict_step

    paths = collect_sources(args.source)
    detector, nc = build_detector(args)
    names = load_class_names(args, nc)
    ood_method = load_ood_method(args)
    neck_ch = detector.neck_channels()
    step = _predict_step(detector, args.conf, mesh, iou_thres=args.iou, max_det=args.max_det)
    save_dir = Path(args.save_dir)
    if not args.no_save or args.save_txt or args.save_json:
        save_dir.mkdir(parents=True, exist_ok=True)

    all_json = []
    bs = args.batch_size
    for start in range(0, len(paths), bs):
        group = paths[start:start + bs]
        batch, pads, origs, raw = letterbox_group(group, args.img_size, bs)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = step(batch)
            # reference convention: 1 = InD, 0 = OoD
            decisions = (_np(_decisions_for_method(ood_method, out, neck_ch))
                         if ood_method is not None else None)
        boxes, conf, valid = _np(out.det.boxes), _np(out.det.conf), _np(out.det.valid)
        cls = _np(out.det.cls).astype(int)
        dt_ms = (time.perf_counter() - t0) * 1e3 / max(len(group), 1)

        for i, p in enumerate(group):
            n = int(valid[i].sum())
            b = scale_boxes_back(boxes[i, :n], pads[i], origs[i])
            c, s = cls[i, :n], conf[i, :n]
            dec = decisions[i, :n] if decisions is not None else None
            labels = [names[j] if j < len(names) else f"cls{j}" for j in c]
            counts = {}
            for k, lab in enumerate(labels):
                key = lab if dec is None or dec[k] == 1 else f"OOD {lab}"
                counts[key] = counts.get(key, 0) + 1
            desc = ", ".join(f"{v} {k}" for k, v in counts.items()) or "nothing"
            log.info("%s: %d boxes (%s) %.1f ms", p.name, n, desc, dt_ms)
            if not args.no_save:
                if dec is not None:
                    from ..utils.visualization import plot_detections_with_ood

                    plot_detections_with_ood(raw[i], b, c, s, dec, names,
                                             out_path=str(save_dir / f"{p.stem}_pred.jpg"))
                else:
                    from ..utils.visualization import draw_boxes

                    ann = draw_boxes(raw[i], b, [f"{lab} {sc:.2f}" for lab, sc in zip(labels, s)],
                                     [(0, 200, 0)] * n)
                    Image.fromarray(ann).save(save_dir / f"{p.stem}_pred.jpg")
            if args.save_txt:
                h, w = origs[i]
                lines = []
                for j in range(n):
                    x1, y1, x2, y2 = b[j]
                    line = (f"{int(c[j])} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                            f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f} {s[j]:.6f}")
                    if dec is not None:
                        line += f" {int(dec[j])}"  # trailing 1 = InD / 0 = OoD
                    lines.append(line)
                (save_dir / f"{p.stem}.txt").write_text("\n".join(lines) + "\n")
            for j in range(n):
                rec = {"image": str(p), "bbox": [float(v) for v in b[j]], "category": int(c[j]),
                       "name": labels[j], "score": float(s[j])}
                if dec is not None:
                    rec["is_ood"] = bool(dec[j] == 0)
                all_json.append(rec)
    if args.save_json:
        (save_dir / "predictions.json").write_text(json.dumps(all_json, indent=1))
        log.info("wrote %d detections to %s", len(all_json), save_dir / "predictions.json")
    return all_json


if __name__ == "__main__":
    main()
