"""Visualization of predictions with OoD verdicts (PIL-based).

Capability parity with reference visualization_utils.py:21-196
(torchvision draw_bounding_boxes): green InD boxes, red OoD boxes, violet
ground truth, orange unknown proposals; per-box class/conf labels; saves one
image per sample.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

COLORS = {
    "ind": (0, 200, 0),
    "ood": (220, 30, 30),
    "target": (160, 60, 200),
    "unk_proposal": (255, 160, 20),
}


def create_folder(path: str) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def draw_boxes(img_u8: np.ndarray, boxes_xyxy: np.ndarray,
               labels: Sequence[str], colors: Sequence[tuple], width: int = 2):
    from PIL import Image, ImageDraw

    im = Image.fromarray(img_u8)
    dr = ImageDraw.Draw(im)
    for b, lab, col in zip(boxes_xyxy, labels, colors):
        x1, y1, x2, y2 = [float(v) for v in b]
        dr.rectangle([x1, y1, x2, y2], outline=col, width=width)
        if lab:
            dr.text((x1 + 2, max(y1 - 12, 0)), lab, fill=col)
    return np.asarray(im)


def plot_detections_with_ood(
    img: np.ndarray,                    # (H, W, 3) uint8 or float in [0,1]
    boxes: np.ndarray,                  # (N, 4) xyxy
    cls: np.ndarray,
    conf: np.ndarray,
    ood_decision: np.ndarray,           # (N,) 1=InD 0=OoD
    class_names: Sequence[str],
    targets_boxes: Optional[np.ndarray] = None,
    targets_cls: Optional[np.ndarray] = None,
    unk_proposals: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
) -> np.ndarray:
    """Render one image (reference save_image_from_results_and_data /
    plot_bounding_boxes, visualization_utils.py:21-149)."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    all_boxes, labels, colors = [], [], []
    for i in range(len(boxes)):
        ind = int(ood_decision[i]) == 1
        c = int(cls[i])
        name = class_names[c] if c < len(class_names) else f"cls{c}"
        all_boxes.append(boxes[i])
        labels.append(f"{name} {float(conf[i]):.2f}" + ("" if ind else " OOD"))
        colors.append(COLORS["ind"] if ind else COLORS["ood"])
    if targets_boxes is not None:
        for i in range(len(targets_boxes)):
            all_boxes.append(targets_boxes[i])
            c = int(targets_cls[i]) if targets_cls is not None else -1
            labels.append(class_names[c] if 0 <= c < len(class_names) else "gt")
            colors.append(COLORS["target"])
    if unk_proposals is not None:
        for i in range(len(unk_proposals)):
            all_boxes.append(unk_proposals[i])
            labels.append("unk?")
            colors.append(COLORS["unk_proposal"])
    out = draw_boxes(img, np.asarray(all_boxes).reshape(-1, 4), labels, colors)
    if out_path:
        from PIL import Image

        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(out).save(out_path)
    return out


def plot_batch_results(batch: Dict, det_out, decisions: np.ndarray,
                       class_names: Sequence[str], folder: str, prefix: str = "",
                       image_format: str = "jpg") -> List[Path]:
    """Render every image of a batch (reference plot_results,
    visualization_utils.py:151-196)."""
    folder_p = create_folder(folder)
    paths = []
    boxes = np.asarray(det_out.det.boxes)
    conf = np.asarray(det_out.det.conf)
    cls = np.asarray(det_out.det.cls)
    valid = np.asarray(det_out.det.valid)
    for i in range(len(boxes)):
        n = int(valid[i].sum())
        tgt_m = batch["gt_mask"][i]
        p = folder_p / f"{prefix}{batch['im_names'][i]}.{image_format}"
        plot_detections_with_ood(
            batch["images"][i], boxes[i, :n], cls[i, :n], conf[i, :n],
            np.asarray(decisions)[i, :n], class_names,
            targets_boxes=batch["gt_bboxes"][i][tgt_m],
            targets_cls=batch["gt_labels"][i][tgt_m],
            out_path=str(p),
        )
        paths.append(p)
    return paths
