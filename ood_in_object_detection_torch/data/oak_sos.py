"""OAK and SOS dataset tooling.

Capability parity with the reference's ancillary dataset converters:

- OAK (reference datasets_utils/oak/convert_oak_format_to_ultralytics.py):
  the raw OAK layout ``{split}/Raw/<video>/<frame>.jpg`` +
  ``{split}/Labels/<video>/<frame>.json`` (per-image JSON list of
  ``{id, category, box2d{x1,y1,x2,y2}}`` in pixels) is converted to the
  YOLO-txt layout our DetectionDataset.from_yaml loads directly:
  ``images/{split}/...jpg``, ``labels/{split}/...txt`` (cxcywh-normalized),
  a ``{split}.txt`` image list, and a dataset YAML.

- SOS (reference datasets_utils/sos/sos_dataset.py +
  data_utils.segmentation_to_bbox): per-image instance-segmentation PNGs are
  reduced to bounding boxes and written as a COCO-style annotations JSON,
  which DetectionDataset.from_coco_json consumes (every SOS object is a
  single OoD "street obstacle" category).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# OAK
# ---------------------------------------------------------------------------


def oak_annotations_to_yolo_lines(anns: List[dict], n_classes: int,
                                  img_w: int, img_h: int) -> List[str]:
    """One image's OAK JSON annotation list -> YOLO txt lines
    (reference extract_one_img_annotations_from_json: classes with
    id >= n_classes are dropped; boxes normalized cxcywh)."""
    lines = []
    for ann in anns:
        if int(ann["id"]) >= n_classes:
            continue
        b = ann["box2d"]
        cx = (b["x1"] + b["x2"]) / 2 / img_w
        cy = (b["y1"] + b["y2"]) / 2 / img_h
        w = (b["x2"] - b["x1"]) / img_w
        h = (b["y2"] - b["y1"]) / img_h
        lines.append(f'{int(ann["id"])} {cx} {cy} {w} {h}\n')
    return lines


def convert_oak_to_yolo(
    src_root: str,
    dst_root: str,
    classes: Dict[str, int],
    splits: Sequence[str] = ("train", "val"),
    n_classes: int = 0,
    link_images: bool = True,
) -> str:
    """Convert an OAK tree to the ultralytics/YOLO-txt layout; returns the
    written dataset YAML path (reference generate_ultralytics_yolo_annotations
    minus the hardcoded NFS paths)."""
    src = Path(src_root)
    dst = Path(dst_root)
    if n_classes <= 0:
        n_classes = len(classes)
    names = {v: k for k, v in classes.items() if v < n_classes}

    for split in splits:
        img_out = dst / "images" / split
        lab_out = dst / "labels" / split
        img_out.mkdir(parents=True, exist_ok=True)
        lab_out.mkdir(parents=True, exist_ok=True)
        image_list = []
        labels_dir = src / split / "Labels"
        raws_dir = src / split / "Raw"
        for jf in sorted(labels_dir.rglob("*.json")):
            rel = jf.relative_to(labels_dir).with_suffix("")
            img_src = None
            for ext in (".jpg", ".png", ".jpeg"):
                cand = raws_dir / rel.parent / (rel.name + ext)
                if cand.exists():
                    img_src = cand
                    break
            if img_src is None:
                continue
            from PIL import Image

            with Image.open(img_src) as im:
                w, h = im.size
            lines = oak_annotations_to_yolo_lines(
                json.loads(jf.read_text()), n_classes, w, h)
            (lab_out / rel.parent).mkdir(parents=True, exist_ok=True)
            (img_out / rel.parent).mkdir(parents=True, exist_ok=True)
            (lab_out / rel.parent / (rel.name + ".txt")).write_text("".join(lines))
            img_dst = img_out / rel.parent / img_src.name
            if not img_dst.exists():
                if link_images:
                    img_dst.symlink_to(img_src.resolve())
                else:
                    shutil.copy(img_src, img_dst)
            image_list.append(str(img_dst.relative_to(dst)))
        (dst / f"{split}.txt").write_text("\n".join(image_list) + "\n")

    yaml_path = dst / f"OAK_{n_classes}_classes.yaml"
    names_yaml = "\n".join(f"  {i}: {names[i]}" for i in sorted(names))
    yaml_path.write_text(
        f"path: {dst}\ntrain: train.txt\nval: val.txt\ntest: val.txt\n"
        f"nc: {n_classes}\nnames:\n{names_yaml}\n")
    return str(yaml_path)


# ---------------------------------------------------------------------------
# SOS
# ---------------------------------------------------------------------------


def segmentation_to_bbox(seg: np.ndarray, value: int) -> Tuple[int, int, int, int]:
    """Instance-mask value -> xyxy bbox (reference data_utils.py:20-30)."""
    ys, xs = np.where(seg == value)
    if xs.size == 0:
        return (0, 0, 0, 0)
    return (int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))


def sos_to_coco_json(
    images_dir: str,
    segmentations_dir: str,
    out_json: str,
    category_id: int = 1,
    category_name: str = "street_obstacle",
    background_values: Sequence[int] = (0,),
    min_box_size: int = 2,
) -> str:
    """Build a COCO-style annotations JSON from SOS instance-segmentation PNGs
    (reference create_annotations_json_for_sos_dataset,
    sos_dataset.py:255-352): each unique non-background mask value becomes one
    box annotation. The result loads via DetectionDataset.from_coco_json."""
    from PIL import Image

    images_dir_p = Path(images_dir)
    seg_dir = Path(segmentations_dir)
    out = {"images": [], "annotations": [],
           "categories": [{"id": category_id, "name": category_name}]}
    ann_id = 0
    img_id = 0
    for img_f in sorted(images_dir_p.rglob("*")):
        if img_f.suffix.lower() not in (".jpg", ".jpeg", ".png", ".webp"):
            continue
        seg_f = None
        for ext in (".png", ".webp"):
            cand = seg_dir / img_f.relative_to(images_dir_p).with_suffix(ext)
            if cand.exists():
                seg_f = cand
                break
        if seg_f is None:
            continue
        with Image.open(seg_f) as sim:
            seg = np.array(sim)
            w, h = sim.size
        if seg.ndim == 3:
            seg = seg[..., 0]
        out["images"].append({"id": img_id, "width": w, "height": h,
                              "file_name": str(img_f.relative_to(images_dir_p))})
        for val in np.unique(seg):
            if int(val) in background_values:
                continue
            x1, y1, x2, y2 = segmentation_to_bbox(seg, int(val))
            if x2 - x1 < min_box_size or y2 - y1 < min_box_size:
                continue
            out["annotations"].append({
                "id": ann_id, "image_id": img_id, "category_id": category_id,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1), "iscrowd": 0,
                "segmentation": [],
            })
            ann_id += 1
        img_id += 1
    Path(out_json).parent.mkdir(parents=True, exist_ok=True)
    Path(out_json).write_text(json.dumps(out))
    return out_json
