"""The plain reference's predict step, OoD fit and per-box record.

``Reference`` wraps a ``model.YOLO`` with the cell's thresholds and
precision (:mod:`.precision`: the model, the decode and the taps all run
at it): ``predict`` gives every anchor's decoded values and the kept
anchors of each image, from the model's own maps or (``from_maps``) from
maps it is handed; ``fit`` fits a method on InD batches labelled by their
own most confident boxes; ``record`` gives the per-box record the
program's output is turned into, so that the reference in a lower
precision, the control, can stand in the program's place. ``capture``
records each top-level layer's input and output during a forward, for the
layer-by-layer comparison. Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from . import detect as D
from . import ood as O
from . import precision as P


class Prediction(NamedTuple):
    raw: list
    neck: list          # (B, C, H, W) f32 per level
    anchors: D.Anchors
    kept: List[np.ndarray]  # per image, kept anchor indices, most confident first


@contextlib.contextmanager
def capture(layers, into: Dict[int, tuple]):
    """Forward hooks on ``layers`` (a ModuleList) storing ``{index: (input,
    output)}`` of each call while the context is open."""
    def hook(i):
        def fn(module, args, out):
            into[i] = (args[0], out)
        return fn

    handles = [m.register_forward_hook(hook(i)) for i, m in enumerate(layers)]
    try:
        yield into
    finally:
        for h in handles:
            h.remove()


def as_f32(x):
    if isinstance(x, (list, tuple)):
        return [t.float() for t in x]
    return x.float()


class Reference:
    def __init__(self, model, cfg: dict, wl: dict, mode: str = "f32"):
        self.model, self.cfg, self.wl, self.mode = model, cfg, wl, mode
        self.img = cfg["img_size"]
        self.nc = cfg["nc"]
        self.channels = list(model.neck_channels)
        self.max_det = wl.get("max_det", 300)

    def device(self):
        return next(self.model.parameters()).device

    def images(self, images: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device()).permute(0, 3, 1, 2).float() / 255.0

    @torch.no_grad()
    def forward(self, images: np.ndarray, layers: Dict[int, tuple] = None):
        """(raw, neck) maps at this precision; with ``layers``, each layer's
        input and output too."""
        with P.precision(self.mode), (capture(self.model.model, layers) if layers is not None
                                      else contextlib.nullcontext()):
            return self.model(self.images(images))

    @torch.no_grad()
    def predict(self, images: np.ndarray, layers: Dict[int, tuple] = None) -> Prediction:
        raw, neck = self.forward(images, layers)
        return self.from_maps(raw, neck)

    @torch.no_grad()
    def from_maps(self, raw, neck) -> Prediction:
        raw, neck = as_f32(raw), as_f32(neck)
        with P.precision(self.mode):
            anchors = D.decode(raw, self.nc)
        kept = D.nms(anchors, self.wl["conf_thres"], self.wl["iou_thres"], self.max_det,
                     self.wl["pre_nms_k"])
        return Prediction(raw, neck, anchors, kept)

    def box_taps(self, pred: Prediction, image: int, anchor_idx: np.ndarray, outside="border"):
        """Per anchor: (unclipped box, level, RoI feature, exact feature), the
        features cut to the level's channels, as numpy arrays."""
        a = torch.as_tensor(np.asarray(anchor_idx, np.int64), device=pred.anchors.boxes.device)
        boxes = pred.anchors.boxes[image, a]
        level = pred.anchors.level[a]
        with P.precision(self.mode):
            roi, exact = D.taps(pred.neck, image, boxes, level, pred.anchors.local[a], self.img,
                                outside)
        return boxes, level, roi, exact

    def fit(self, preds: List[Prediction], max_gt: int, method: str) -> O.Fitted:
        """The method fitted on InD predictions, each image's ground truth
        its own ``max_gt`` most confident boxes (every one of them matches
        itself)."""
        samples = []
        for pred in preds:
            logits = O.to_numpy(pred.anchors.logits)
            cls = pred.anchors.cls.cpu().numpy()
            for i, kept in enumerate(pred.kept):
                gt = kept[:max_gt]
                if len(gt) == 0:
                    continue
                _, level, roi, _ = self.box_taps(pred, i, gt)
                level = level.cpu().numpy()
                for k, a in enumerate(gt):
                    samples.append(dict(cls=int(cls[i, a]), level=int(level[k]),
                                        logits=logits[i, a], roi=roi[k]))
        return O.Fitted(method, self.nc).fit(samples)

    def record(self, pred: Prediction, fitted: O.Fitted) -> dict:
        """The program's per-box outputs, as this reference computes them."""
        b, m, cmax = len(pred.kept), self.max_det, max(self.channels)
        rec = dict(valid=np.zeros((b, m), bool), anchor=np.zeros((b, m), np.int64),
                   boxes=np.zeros((b, m, 4), np.float32), conf=np.zeros((b, m), np.float32),
                   cls=np.zeros((b, m), np.int64), logits=np.zeros((b, m, self.nc), np.float32),
                   roi=np.zeros((b, m, cmax), np.float32), exact=np.zeros((b, m, cmax), np.float32),
                   decision=np.zeros((b, m), np.int64), neck=pred.neck, raw=pred.raw)
        conf = O.to_numpy(pred.anchors.conf)
        cls = pred.anchors.cls.cpu().numpy()
        logits = O.to_numpy(pred.anchors.logits)
        for i, kept in enumerate(pred.kept):
            n = len(kept)
            if n == 0:
                continue
            boxes, level, roi, exact = self.box_taps(pred, i, kept)
            level = level.cpu().numpy()
            rec["valid"][i, :n] = True
            rec["anchor"][i, :n] = kept
            rec["boxes"][i, :n] = O.to_numpy(boxes.clamp(0, self.img))
            rec["conf"][i, :n] = conf[i, kept]
            rec["cls"][i, :n] = cls[i, kept]
            rec["logits"][i, :n] = logits[i, kept]
            for k in range(n):
                c = self.channels[level[k]]
                rec["roi"][i, k, :c], rec["exact"][i, k, :c] = roi[k], exact[k]
                rec["decision"][i, k] = fitted.decide(int(cls[i, kept[k]]), int(level[k]),
                                                      logits[i, kept[k]], roi[k])
        return rec
