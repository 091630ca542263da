"""Detection datasets: YOLO-txt, COCO-OOD/Mixed (UnSniffer JSON), OWOD tasks.

Capability parity with the reference data layer:

- YOLO-format label txts + dataset YAML with ``path``/``train``/``val`` lists
  (ultralytics/data/base.py get_img_files, dataset.py get_labels),
- ``FilteredYOLODataset`` semantics (ultralytics/data/dataset.py:840-1170):
  COCO-OOD / COCO-Mixed label rebuild from UnSniffer JSONs (category_id - 1,
  class 80 = unknown, COCO-OOD -> OWOD class remap via the YAML's
  ``coco_to_owod_mapping``), OWOD task image lists (t1..t4 via tasks/*.txt),
  task class counts t1=20 .. t4=80, class filtering,
- fixed-shape padded batches with letterboxed images and xyxy pixel targets —
  the TPU-native replacement for the ragged collate + ``create_targets_dict``
  conversion (reference ood_utils.py:201-231).

Host side only; images load via PIL. The batcher prefetches on a thread.
"""

from __future__ import annotations

import json
import queue
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .letterbox import letterbox_np

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}
UNKNOWN_CLASS_INDEX = 80
_COCO_NAME_RE = re.compile(r"^\d{12}\.(jpg|png)$")

OWOD_TASK_NUM_CLASSES = {"t1": 20, "t2": 40, "t3": 60, "t4": 80, "all_task_test": 80}


@dataclass
class Label:
    im_file: str
    shape: tuple  # (h, w) original
    cls: np.ndarray  # (N,)
    bboxes: np.ndarray  # (N, 4) cxcywh normalized to original image


@dataclass
class DetectionDataset:
    labels: List[Label]
    names: List[str]
    number_of_classes: int
    yaml_name: str = "dataset"

    def __len__(self):
        return len(self.labels)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _img2label_path(im_file: str) -> str:
        p = Path(im_file)
        # ultralytics convention: .../images/... -> .../labels/... with .txt
        parts = list(p.parts)
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == "images":
                parts[i] = "labels"
                break
        return str(Path(*parts).with_suffix(".txt"))

    @classmethod
    def from_image_list(
        cls,
        im_files: Sequence[str],
        names: Sequence[str],
        yaml_name: str = "dataset",
        number_of_classes: Optional[int] = None,
    ) -> "DetectionDataset":
        from PIL import Image

        labels = []
        for f in sorted(im_files):
            lp = cls._img2label_path(f)
            with Image.open(f) as im:
                w, h = im.size
            if Path(lp).exists():
                rows = np.loadtxt(lp, ndmin=2, dtype=np.float64)
                if rows.size == 0:
                    rows = np.empty((0, 5))
            else:
                rows = np.empty((0, 5))
            labels.append(Label(
                im_file=f, shape=(h, w),
                cls=rows[:, 0].astype(np.float32),
                bboxes=rows[:, 1:5].astype(np.float32),
            ))
        return cls(labels, list(names), number_of_classes or len(names), yaml_name)

    @classmethod
    def from_yaml(
        cls,
        yaml_path: str,
        split: str = "val",
        owod_task: Optional[str] = None,
        tasks_dir: Optional[str] = None,
    ) -> "DetectionDataset":
        """Build from a dataset YAML, dispatching on ``dataset_class`` /
        ``ood_or_mixed`` like the reference builders (data/build.py:132-173)."""
        import yaml as pyyaml

        ypath = Path(yaml_path)
        spec = pyyaml.safe_load(ypath.read_text())
        names = spec["names"]
        if isinstance(names, dict):
            names = [names[k] for k in sorted(names)]
        root = Path(spec.get("path", ypath.parent))
        if not root.is_absolute():
            root = (ypath.parent / root).resolve()

        ood_or_mixed = spec.get("ood_or_mixed")
        if ood_or_mixed:
            json_files = [str(root / j) if not Path(j).is_absolute() else j
                          for j in spec["json_files"]]
            img_dir = spec.get(split) or spec["val"]
            img_dir = root / img_dir if not Path(img_dir).is_absolute() else Path(img_dir)
            mapping = spec.get("coco_to_owod_mapping")
            ds = cls.from_unsniffer_json(
                json_files, str(img_dir), names, ood_or_mixed, mapping,
                yaml_name=ypath.stem)
            return ds

        source = spec.get(split)
        if source is None:
            raise ValueError(f"split {split!r} not in {yaml_path}")
        src = root / source if not Path(str(source)).is_absolute() else Path(source)
        im_files: List[str] = []
        if src.is_dir():
            im_files = [str(p) for p in src.rglob("*.*")
                        if p.suffix[1:].lower() in IMG_FORMATS]
        else:
            for line in src.read_text().strip().splitlines():
                line = line.strip()
                if line.startswith("./"):
                    line = str(root / line[2:])
                elif line and not Path(line).is_absolute():
                    # relative entries resolve against the yaml `path` root
                    # (reference FilteredYOLODataset.get_img_files,
                    # dataset.py:928-957)
                    line = str(root / line)
                im_files.append(line)
        ds = cls.from_image_list(im_files, names, yaml_name=ypath.stem)

        if owod_task:
            nc = OWOD_TASK_NUM_CLASSES.get(owod_task, len(names))
            ds.number_of_classes = nc
            mapping = spec.get("coco_to_owod_mapping")
            if mapping:
                ds.map_coco_to_owod(mapping)
            if tasks_dir:
                ds.limit_images_by_task(owod_task, split, tasks_dir)
            ds.filter_classes(list(range(nc)),
                              remove_empty=spec.get("remove_images_with_no_annotations", False))
        return ds

    @classmethod
    def from_unsniffer_json(
        cls,
        json_files: Sequence[str],
        img_dir: str,
        names: Sequence[str],
        ood_or_mixed: str,
        coco_to_owod_mapping: Optional[Dict[int, int]] = None,
        yaml_name: str = "coco_ood",
    ) -> "DetectionDataset":
        """COCO-OOD / COCO-Mixed label rebuild (reference dataset.py:1000-1067):
        merge the InD + OOD annotation JSONs for 'mixed'; category_id is
        1-offset; id 81 -> unknown (80); known ids remapped COCO->OWOD."""
        anns = json.loads(Path(json_files[0]).read_text())
        if ood_or_mixed == "mixed":
            extra = json.loads(Path(json_files[1]).read_text())
            anns["annotations"].extend(extra["annotations"])
        elif ood_or_mixed != "ood":
            raise ValueError(f"invalid ood_or_mixed: {ood_or_mixed}")

        img_dir_p = Path(img_dir)
        by_id: Dict[int, dict] = {}
        for im in anns["images"]:
            f = img_dir_p / im["file_name"]
            if not f.exists():
                continue
            by_id[im["id"]] = dict(
                im_file=str(f), shape=(im["height"], im["width"]), cls=[], bboxes=[])
        skipped = 0
        for ann in anns["annotations"]:
            rec = by_id.get(ann["image_id"])
            if rec is None:
                skipped += 1
                continue
            c = ann["category_id"] - 1
            if c != UNKNOWN_CLASS_INDEX and coco_to_owod_mapping:
                c = coco_to_owod_mapping[c]
            x, y, w, h = ann["bbox"]
            ih, iw = rec["shape"]
            rec["cls"].append(c)
            rec["bboxes"].append([(x + w / 2) / iw, (y + h / 2) / ih, w / iw, h / ih])
        labels = [
            Label(r["im_file"], r["shape"],
                  np.asarray(r["cls"], np.float32),
                  np.asarray(r["bboxes"], np.float32).reshape(-1, 4))
            for r in by_id.values()
        ]
        return cls(labels, list(names), number_of_classes=20, yaml_name=yaml_name)

    @classmethod
    def from_coco_json(
        cls,
        json_file: str,
        img_root: str,
        names: Sequence[str],
        category_id_to_class: Optional[Dict[int, int]] = None,
        yaml_name: str = "coco_json",
        skip_missing_images: bool = True,
    ) -> "DetectionDataset":
        """Generic COCO-JSON dataset (covers the reference's TAODataset,
        data/tao.py:52-326: video frames listed in a COCO json with a
        TAO->COCO category remap table; file_name paths are relative to the
        dataset root)."""
        anns = json.loads(Path(json_file).read_text())
        remap = {int(k): int(v) for k, v in (category_id_to_class or {}).items()}
        root = Path(img_root)
        by_id: Dict[int, dict] = {}
        for im in anns["images"]:
            f = root / im["file_name"]
            if skip_missing_images and not f.exists():
                continue
            by_id[im["id"]] = dict(im_file=str(f),
                                   shape=(im["height"], im["width"]),
                                   cls=[], bboxes=[])
        for ann in anns.get("annotations", []):
            rec = by_id.get(ann["image_id"])
            if rec is None:
                continue
            cid = ann["category_id"]
            c = remap.get(cid, cid)
            if c is None or c < 0:
                continue
            x, y, w, h = ann["bbox"]
            ih, iw = rec["shape"]
            rec["cls"].append(c)
            rec["bboxes"].append([(x + w / 2) / iw, (y + h / 2) / ih, w / iw, h / ih])
        labels = [
            Label(r["im_file"], r["shape"],
                  np.asarray(r["cls"], np.float32),
                  np.asarray(r["bboxes"], np.float32).reshape(-1, 4))
            for r in by_id.values()
        ]
        return cls(labels, list(names), number_of_classes=len(names), yaml_name=yaml_name)

    # ------------------------------------------------------------------ #
    def map_coco_to_owod(self, mapping: Dict[int, int]):
        """Remap classes of COCO-named images (12-digit names) COCO->OWOD
        (reference dataset.py:1070-1085)."""
        mapping = {int(k): int(v) for k, v in mapping.items()}
        for lb in self.labels:
            if _COCO_NAME_RE.match(Path(lb.im_file).name) and lb.cls.size:
                lb.cls = np.asarray([mapping[int(c)] for c in lb.cls], np.float32)

    def limit_images_by_task(self, task: str, split: str, tasks_dir: str):
        """Keep only images listed in the OWOD task txt
        (reference dataset.py:1103-1166)."""
        mode = "train" if split == "train" else "val"
        fname = {
            ("t1", "train"): "t1_train.txt", ("t1", "val"): "t1_known_test.txt",
            ("t2", "train"): "t2_train.txt",
            ("t3", "train"): "t3_train.txt",
            ("t4", "train"): "t4_train.txt",
            ("all_task_test", "val"): "all_task_test.txt",
        }.get((task, mode))
        if fname is None:
            raise ValueError(f"invalid OWOD task/mode: {task}/{mode}")
        stems = set(Path(tasks_dir, fname).read_text().split())
        self.labels = [lb for lb in self.labels if Path(lb.im_file).stem in stems]

    def filter_classes(self, keep: Sequence[int], remove_empty: bool = False):
        keep_set = np.asarray(sorted(keep))
        for lb in self.labels:
            mask = np.isin(lb.cls, keep_set)
            lb.cls = lb.cls[mask]
            lb.bboxes = lb.bboxes[mask]
        if remove_empty:
            self.labels = [lb for lb in self.labels if lb.cls.size > 0]

    def select_subset(self, stems: Sequence[str]):
        s = set(stems)
        self.labels = [lb for lb in self.labels if Path(lb.im_file).stem in s]


# ---------------------------------------------------------------------------
# Fixed-shape batching with letterbox + threaded prefetch
# ---------------------------------------------------------------------------


def _boxes_to_letterboxed_xyxy(label: Label, ratio_pad) -> np.ndarray:
    (r, _), (dw, dh) = ratio_pad
    h, w = label.shape
    if not label.bboxes.size:
        return np.empty((0, 4), np.float32)
    cx = label.bboxes[:, 0] * w * r + dw
    cy = label.bboxes[:, 1] * h * r + dh
    bw = label.bboxes[:, 2] * w * r
    bh = label.bboxes[:, 3] * h * r
    return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).astype(np.float32)


def load_and_letterbox(label: Label, img_size: int):
    from PIL import Image

    with Image.open(label.im_file) as im:
        img = np.asarray(im.convert("RGB"))
    lbimg, ratio_pad = letterbox_np(img, (img_size, img_size))
    return lbimg, _boxes_to_letterboxed_xyxy(label, ratio_pad), ratio_pad


def load_and_letterbox_into(label: Label, dst_f32: np.ndarray, img_size: int):
    """Decode + letterbox + normalize directly into the batch buffer using the
    native C++ kernel when available (data/native.py)."""
    from PIL import Image

    from .native import letterbox_into

    with Image.open(label.im_file) as im:
        img = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    ratio_pad = letterbox_into(img, dst_f32, img_size)
    return _boxes_to_letterboxed_xyxy(label, ratio_pad), ratio_pad


_POOLS: Dict[int, "object"] = {}
_POOLS_LOCK = threading.Lock()


def _shared_pool(workers: int):
    """Process-wide decode pool shared by every PaddedBatcher with the same
    worker count — per-instance pools would leak their threads for the process
    lifetime each time a CLI constructs a batcher per split/epoch."""
    from concurrent.futures import ThreadPoolExecutor

    with _POOLS_LOCK:
        pool = _POOLS.get(workers)
        if pool is None:
            pool = _POOLS[workers] = ThreadPoolExecutor(max_workers=workers)
        return pool


class PaddedBatcher:
    """Iterate fixed-shape batches:
    images (B,S,S,3) f32 in [0,1]; gt_bboxes (B,M,4) xyxy letterboxed pixels;
    gt_labels (B,M) int32; gt_mask (B,M) bool; im_names; ratio_pad (B,2,2);
    orig_shapes (B,2). Last partial batch is padded with repeats + batch_mask."""

    def __init__(self, dataset: DetectionDataset, batch_size: int = 16,
                 img_size: int = 640, max_gt: int = 128, prefetch: int = 2,
                 image_dtype: str = "float32", workers: int = 4):
        self.ds = dataset
        self.bs = batch_size
        self.img_size = img_size
        self.max_gt = max_gt
        self.prefetch = prefetch
        # 'uint8' ships raw letterboxed bytes and normalizes on device
        # (4x less host->device traffic; engine.Detector handles both)
        self.image_dtype = image_dtype
        # intra-batch decode parallelism (PIL decode + the native letterbox
        # kernel release the GIL); the reference's analogue is the torch
        # DataLoader worker pool (data/build.py)
        self.workers = max(1, workers)

    def __len__(self):
        return (len(self.ds) + self.bs - 1) // self.bs

    def _make_batch(self, idxs: List[int]) -> Dict:
        n = len(idxs)
        B = self.bs
        S = self.img_size
        u8 = self.image_dtype == "uint8"
        images = np.zeros((B, S, S, 3), np.uint8 if u8 else np.float32)
        gtb = np.zeros((B, self.max_gt, 4), np.float32)
        gtc = np.zeros((B, self.max_gt), np.int32)
        gtm = np.zeros((B, self.max_gt), bool)
        rp = np.zeros((B, 2, 2), np.float32)
        osh = np.zeros((B, 2), np.int32)
        names = [""] * B

        def fill(j: int):
            lb = self.ds.labels[idxs[j % n]]
            if u8:
                from PIL import Image

                with Image.open(lb.im_file) as im:
                    raw = np.asarray(im.convert("RGB"))
                images[j], ratio_pad = letterbox_np(raw, (S, S))
                xyxy = _boxes_to_letterboxed_xyxy(lb, ratio_pad)
            else:
                xyxy, ratio_pad = load_and_letterbox_into(lb, images[j], S)
            m = min(len(xyxy), self.max_gt)
            gtb[j, :m] = xyxy[:m]
            gtc[j, :m] = lb.cls[:m].astype(np.int32)
            gtm[j, :m] = True
            rp[j] = np.asarray(ratio_pad, np.float32)
            osh[j] = lb.shape
            names[j] = Path(lb.im_file).stem

        if self.workers > 1 and B > 1:
            list(_shared_pool(self.workers).map(fill, range(B)))
        else:
            for j in range(B):
                fill(j)
        return dict(images=images, gt_bboxes=gtb, gt_labels=gtc, gt_mask=gtm,
                    ratio_pad=rp, orig_shapes=osh, im_names=names,
                    batch_mask=np.arange(B) < n)

    def __iter__(self) -> Iterator[Dict]:
        order = list(range(len(self.ds)))
        chunks = [order[i : i + self.bs] for i in range(0, len(order), self.bs)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def worker():
            for ch in chunks:
                q.put(self._make_batch(ch))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is None:
                return
            yield b
