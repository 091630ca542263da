"""Training augmentations (host-side NumPy).

Capability parity with the reference train-time transform stack
(ultralytics/data/augment.py v8_transforms): 4-image mosaic on a 2S canvas,
self-flip CopyPaste, full RandomPerspective (rotation / translation / scale /
shear / perspective, matrix composition per augment.py affine_transform),
MixUp (beta(32,32) pixel blend of two fully pre-transformed samples), HSV
jitter (hgain 0.015, sgain 0.7, vgain 0.4), horizontal flip p=0.5, and the
trainer's close_mosaic window (mosaic disabled for the final epochs,
cfg/default.yaml close_mosaic=10).

cv2-free: image warps use PIL Image.transform with the inverse matrix;
CopyPaste pastes the rectangular box region (the reference draws segment
polygons, augment.py:1820-1830 — identical for box-only detection labels).

Boxes are cxcywh-normalized in, xyxy-pixel out (matching PaddedBatcher).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .dataset import DetectionDataset, Label
from .letterbox import PAD_VALUE


@dataclass
class AugmentConfig:
    # reference cfg/default.yaml augmentation block
    mosaic: float = 1.0
    degrees: float = 0.0     # rotation (+/- deg)
    translate: float = 0.1
    scale: float = 0.5       # random scale in [1-s, 1+s]
    shear: float = 0.0       # shear (+/- deg)
    perspective: float = 0.0  # perspective (+/- fraction), ~range 0-0.001
    mixup: float = 0.0
    copy_paste: float = 0.0
    fliplr: float = 0.5
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    close_mosaic: int = 10


def _load_rgb(label: Label) -> np.ndarray:
    from PIL import Image

    with Image.open(label.im_file) as im:
        return np.asarray(im.convert("RGB"))


def _boxes_xyxy_abs(label: Label) -> np.ndarray:
    h, w = label.shape
    if not label.bboxes.size:
        return np.empty((0, 4), np.float32)
    cx, cy, bw, bh = (label.bboxes[:, i] for i in range(4))
    return np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                     (cx + bw / 2) * w, (cy + bh / 2) * h], 1).astype(np.float32)


def mosaic4(ds: DetectionDataset, idxs: List[int], img_size: int,
            rng: np.random.Generator):
    """4-image mosaic on a (2S, 2S) canvas (reference augment.py Mosaic):
    random centre in [S/2, 3S/2]^2, each image letterbox-free pasted at its
    corner. Returns canvas, boxes xyxy, cls."""
    s = img_size
    canvas = np.full((2 * s, 2 * s, 3), PAD_VALUE, np.uint8)
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    boxes_all, cls_all = [], []
    for k, idx in enumerate(idxs[:4]):
        lb = ds.labels[idx]
        img = _load_rgb(lb)
        h, w = img.shape[:2]
        r = min(s / h, s / w)
        nh, nw = int(h * r), int(w * r)
        if (nh, nw) != (h, w):
            from PIL import Image

            img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        if k == 0:   # top-left
            x1a, y1a = max(xc - nw, 0), max(yc - nh, 0)
            x2a, y2a = xc, yc
            x1b, y1b = nw - (x2a - x1a), nh - (y2a - y1a)
        elif k == 1:  # top-right
            x1a, y1a = xc, max(yc - nh, 0)
            x2a, y2a = min(xc + nw, 2 * s), yc
            x1b, y1b = 0, nh - (y2a - y1a)
        elif k == 2:  # bottom-left
            x1a, y1a = max(xc - nw, 0), yc
            x2a, y2a = xc, min(yc + nh, 2 * s)
            x1b, y1b = nw - (x2a - x1a), 0
        else:         # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + nw, 2 * s), min(yc + nh, 2 * s)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b : y1b + (y2a - y1a), x1b : x1b + (x2a - x1a)]
        b = _boxes_xyxy_abs(lb) * r
        if len(b):
            b[:, [0, 2]] += x1a - x1b
            b[:, [1, 3]] += y1a - y1b
            boxes_all.append(b)
            cls_all.append(lb.cls)
    boxes = np.concatenate(boxes_all) if boxes_all else np.empty((0, 4), np.float32)
    cls = np.concatenate(cls_all) if cls_all else np.empty(0, np.float32)
    return canvas, boxes, cls


def _perspective_matrix(h: int, w: int, size: Tuple[int, int], degrees: float,
                        translate: float, scale: float, shear: float,
                        perspective: float, rng: np.random.Generator) -> np.ndarray:
    """Compose the reference's T @ S @ R @ P @ C transform
    (augment.py RandomPerspective.affine_transform; same draw order)."""
    C = np.eye(3, dtype=np.float64)
    C[0, 2] = -w / 2
    C[1, 2] = -h / 2
    P = np.eye(3, dtype=np.float64)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3, dtype=np.float64)
    a = math.radians(rng.uniform(-degrees, degrees))
    s = rng.uniform(1 - scale, 1 + scale)
    # cv2.getRotationMatrix2D(angle=a, center=0, scale=s) — positive angle is
    # counter-clockwise in image coords (y down)
    R[0, 0], R[0, 1] = s * math.cos(a), s * math.sin(a)
    R[1, 0], R[1, 1] = -s * math.sin(a), s * math.cos(a)
    S = np.eye(3, dtype=np.float64)
    S[0, 1] = math.tan(math.radians(rng.uniform(-shear, shear)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-shear, shear)))
    T = np.eye(3, dtype=np.float64)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size[0]
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size[1]
    return T @ S @ R @ P @ C


def _warp_image(img: np.ndarray, M: np.ndarray, size: Tuple[int, int],
                perspective: bool) -> np.ndarray:
    """cv2-free warp: PIL transform takes the inverse (output->input) map."""
    from PIL import Image

    Minv = np.linalg.inv(M)
    pim = Image.fromarray(img)
    fill = (PAD_VALUE,) * 3
    if perspective:
        coeffs = (Minv / Minv[2, 2]).flatten()[:8]
        out = pim.transform(size, Image.PERSPECTIVE, tuple(coeffs),
                            Image.BILINEAR, fillcolor=fill)
    else:
        coeffs = Minv[:2].flatten()
        out = pim.transform(size, Image.AFFINE, tuple(coeffs),
                            Image.BILINEAR, fillcolor=fill)
    return np.asarray(out)


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2.0,
                   ar_thr: float = 100.0, area_thr: float = 0.1,
                   eps: float = 1e-16) -> np.ndarray:
    """Keep boxes that survived the warp (reference augment.py box_candidates):
    min size, aspect-ratio cap, and area retention vs the pre-warp box.
    box1/box2 are (N, 4) xyxy before/after."""
    w1, h1 = box1[:, 2] - box1[:, 0], box1[:, 3] - box1[:, 1]
    w2, h2 = box2[:, 2] - box2[:, 0], box2[:, 3] - box2[:, 1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & \
        (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def random_perspective(img: np.ndarray, boxes: np.ndarray, cls: np.ndarray,
                       img_size: int, cfg: "AugmentConfig",
                       rng: np.random.Generator):
    """Full RandomPerspective: rotation/translate/scale/shear/perspective,
    output (S, S). Boxes warped via their 4 corners, clipped, then filtered by
    box_candidates (reference augment.py:1051-1250)."""
    h, w = img.shape[:2]
    size = (img_size, img_size)
    M = _perspective_matrix(h, w, size, cfg.degrees, cfg.translate, cfg.scale,
                            cfg.shear, cfg.perspective, rng)
    out = _warp_image(img, M, size, cfg.perspective > 0)
    if not len(boxes):
        return out, boxes, cls
    n = len(boxes)
    xy = np.ones((n * 4, 3), np.float64)
    xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3]) if cfg.perspective else xy[:, :2]
    xy = xy.reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1).astype(np.float32)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, img_size)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, img_size)
    # area retention compares against the scaled original box (the reference
    # passes box1=bboxes.T * s); the scale lives in M's linear part
    s = math.sqrt(abs(M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]))
    keep = box_candidates(boxes * s, new)
    return out, new[keep], cls[keep]


def mixup_blend(img1, boxes1, cls1, img2, boxes2, cls2, rng: np.random.Generator):
    """MixUp: beta(32,32) pixel blend, labels concatenated
    (reference augment.py:908-931 MixUp._mix_transform)."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    boxes = np.concatenate([boxes1, boxes2]) if len(boxes1) or len(boxes2) else boxes1
    cls = np.concatenate([cls1, cls2]) if len(cls1) or len(cls2) else cls1
    return img, boxes, cls


def _bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N, M) intersection over box2 area
    (reference utils/metrics.py bbox_ioa default iou=False)."""
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area2[None, :] + eps)


def copy_paste_flip(img: np.ndarray, boxes: np.ndarray, cls: np.ndarray,
                    p: float, rng: np.random.Generator):
    """Self-flip CopyPaste (reference augment.py:1790-1830 with labels2={}):
    candidate objects are the image's own boxes mirrored left-right; those
    whose IoA with every existing box is < 0.30 are pasted from the flipped
    image, lowest-overlap first, round(p * n) of them."""
    if p <= 0 or not len(boxes):
        return img, boxes, cls
    h, w = img.shape[:2]
    flipped_boxes = boxes.copy()
    flipped_boxes[:, 0] = w - boxes[:, 2]
    flipped_boxes[:, 2] = w - boxes[:, 0]
    ioa = _bbox_ioa(flipped_boxes, boxes)
    idxs = np.nonzero((ioa < 0.30).all(1))[0]
    if not len(idxs):
        return img, boxes, cls
    idxs = idxs[np.argsort(ioa.max(1)[idxs])]
    flipped_img = img[:, ::-1]
    img = img.copy()
    new_b, new_c = [], []
    for j in idxs[: round(p * len(idxs))]:
        x1, y1, x2, y2 = flipped_boxes[j].astype(int).clip(0, [w, h, w, h])
        if x2 <= x1 or y2 <= y1:
            continue
        img[y1:y2, x1:x2] = flipped_img[y1:y2, x1:x2]
        new_b.append(flipped_boxes[j])
        new_c.append(cls[j])
    if new_b:
        boxes = np.concatenate([boxes, np.stack(new_b)])
        cls = np.concatenate([cls, np.asarray(new_c)])
    return img, boxes, cls


def filter_degenerate(boxes: np.ndarray, cls: np.ndarray, min_wh: float = 2.0):
    if not len(boxes):
        return boxes, cls
    wh_ok = (boxes[:, 2] - boxes[:, 0] > min_wh) & (boxes[:, 3] - boxes[:, 1] > min_wh)
    return boxes[wh_ok], cls[wh_ok]


def hsv_jitter(img: np.ndarray, hgain: float, sgain: float, vgain: float,
               rng: np.random.Generator) -> np.ndarray:
    """HSV gains (reference augment.py RandomHSV, cv2-free implementation)."""
    import colorsys  # noqa: F401  (documented intent; vectorized below)

    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    x = img.astype(np.float32) / 255.0
    mx = x.max(-1)
    mn = x.min(-1)
    v = mx
    s = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-12), 0)
    c = mx - mn
    safe = np.maximum(c, 1e-12)
    rch, g, bch = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == rch, ((g - bch) / safe) % 6,
                 np.where(mx == g, (bch - rch) / safe + 2, (rch - g) / safe + 4)) / 6
    h = (h * r[0]) % 1.0
    s = np.clip(s * r[1], 0, 1)
    v = np.clip(v * r[2], 0, 1)
    i = np.floor(h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p = v * (1 - s); q = v * (1 - f * s); t = v * (1 - (1 - f) * s)
    conds = [(i == k)[..., None] for k in range(6)]
    rgb = np.select(
        conds,
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
         np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return (rgb * 255).astype(np.uint8)


def _geo_sample(ds: DetectionDataset, idx: int, img_size: int,
                cfg: AugmentConfig, rng: np.random.Generator,
                use_mosaic: bool):
    """Geometric pre-transform: mosaic (or letterbox) + CopyPaste +
    RandomPerspective — the reference's MixUp pre_transform
    (augment.py v8_transforms: Compose([Mosaic, CopyPaste, RandomPerspective]))."""
    if use_mosaic and rng.uniform() < cfg.mosaic:
        others = rng.integers(0, len(ds), 3).tolist()
        img, boxes, cls = mosaic4(ds, [idx] + others, img_size, rng)
    else:
        from .letterbox import letterbox_np

        lb = ds.labels[idx]
        img, ratio_pad = letterbox_np(_load_rgb(lb), (img_size, img_size))
        (r, _), (dw, dh) = ratio_pad
        boxes = _boxes_xyxy_abs(lb) * r
        if len(boxes):
            boxes[:, [0, 2]] += dw
            boxes[:, [1, 3]] += dh
        cls = ds.labels[idx].cls
    img, boxes, cls = copy_paste_flip(img, boxes, cls, cfg.copy_paste, rng)
    img, boxes, cls = random_perspective(img, boxes, cls, img_size, cfg, rng)
    return img, boxes, cls


def augmented_sample(ds: DetectionDataset, idx: int, img_size: int,
                     cfg: AugmentConfig, rng: np.random.Generator,
                     use_mosaic: bool = True):
    """One training sample: (image u8 (S,S,3), boxes xyxy (N,4), cls (N,))."""
    img, boxes, cls = _geo_sample(ds, idx, img_size, cfg, rng, use_mosaic)
    if cfg.mixup > 0 and rng.uniform() < cfg.mixup:
        idx2 = int(rng.integers(0, len(ds)))
        img2, boxes2, cls2 = _geo_sample(ds, idx2, img_size, cfg, rng, use_mosaic)
        img, boxes, cls = mixup_blend(img, boxes, cls, img2, boxes2, cls2, rng)
    boxes, cls = filter_degenerate(boxes, cls)
    img = hsv_jitter(img, cfg.hsv_h, cfg.hsv_s, cfg.hsv_v, rng)
    if rng.uniform() < cfg.fliplr:
        img = img[:, ::-1]
        if len(boxes):
            boxes = boxes.copy()
            x1 = img_size - boxes[:, 2]
            x2 = img_size - boxes[:, 0]
            boxes[:, 0], boxes[:, 2] = x1, x2
    return np.ascontiguousarray(img), boxes, cls


class AugmentedTrainBatcher:
    """Shuffled, augmented fixed-shape batches for training (reference
    build_dataloader + YOLODataset train transforms). ``epoch``/``epochs``
    drive close_mosaic."""

    def __init__(self, ds: DetectionDataset, batch_size: int, img_size: int,
                 max_gt: int = 128, cfg: Optional[AugmentConfig] = None,
                 epochs: int = 100, seed: int = 0, workers: int = 4):
        self.ds = ds
        self.bs = batch_size
        self.img_size = img_size
        self.max_gt = max_gt
        self.cfg = cfg or AugmentConfig()
        self.epochs = epochs
        self.epoch = 0
        self.workers = max(1, workers)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return max(len(self.ds) // self.bs, 1)

    def __iter__(self):
        use_mosaic = self.epoch < self.epochs - self.cfg.close_mosaic
        order = self._rng.permutation(len(self.ds))
        S = self.img_size
        for start in range(0, len(order) - self.bs + 1, self.bs):
            B = self.bs
            images = np.zeros((B, S, S, 3), np.float32)
            gtb = np.zeros((B, self.max_gt, 4), np.float32)
            gtc = np.zeros((B, self.max_gt), np.int32)
            gtm = np.zeros((B, self.max_gt), bool)
            # one spawned child stream per sample: thread-safe AND the
            # augmentation draws are deterministic regardless of worker
            # scheduling (a shared rng under a pool would be neither)
            rngs = self._rng.spawn(B)

            def fill(j):
                img, boxes, cls = augmented_sample(
                    self.ds, int(order[start + j]), S, self.cfg, rngs[j],
                    use_mosaic)
                images[j] = img.astype(np.float32) / 255.0
                m = min(len(boxes), self.max_gt)
                gtb[j, :m] = boxes[:m]
                gtc[j, :m] = cls[:m].astype(np.int32)
                gtm[j, :m] = True

            if self.workers > 1 and B > 1:
                from .dataset import _shared_pool

                list(_shared_pool(self.workers).map(fill, range(B)))
            else:
                for j in range(B):
                    fill(j)
            yield dict(images=images, gt_bboxes=gtb, gt_labels=gtc, gt_mask=gtm)
        self.epoch += 1
