"""The numbers that decide ``correct``: the program's output against the reference.

Each number is a widest gap or a share, and each has a limit of its own
in the cell's workload file (``limits``), set from the program's readings
over a dozen seeds and the control's (PERF.md). A number no limit is
given for is reported and not judged.

``roi_rel_torchvision`` is reported and never judged: the RoI taps against
torchvision's rule for samples more than a cell outside the map, which the
program does not follow (PERF.md, Open questions).

Eval cells compare, per box the program kept, the reference's values at
the same anchor; the serve cell, which returns no anchors, matches each
served box to the reference's own boxes of that image.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import detect as D
from .reference.ood import Fitted, to_numpy
from .reference import precision as P
from .reference.pipeline import Prediction, Reference, as_f32


def _rel(num: float, den: float) -> float:
    return float(np.sqrt(num) / max(np.sqrt(den), 1e-30))


class Tally:
    """Sums and maxima over the compared batches."""

    def __init__(self):
        self.sq = {}
        self.mx = {}
        self.count = {}

    def add_sq(self, name, diff, ref):
        d, r = self.sq.get(name, (0.0, 0.0))
        self.sq[name] = (d + float(np.sum(np.square(diff, dtype=np.float64))),
                         r + float(np.sum(np.square(ref, dtype=np.float64))))

    def add_max(self, name, value):
        self.mx[name] = max(self.mx.get(name, 0.0), float(value))

    def add_count(self, name, hits, total):
        h, t = self.count.get(name, (0, 0))
        self.count[name] = (h + int(hits), t + int(total))

    def numbers(self) -> Dict[str, float]:
        out = {k: _rel(*v) for k, v in self.sq.items()}
        out.update(self.mx)
        out.update({k: h / max(t, 1) for k, (h, t) in self.count.items()})
        return out


def _rel_t(got, want) -> float:
    """||got - want|| / ||want|| over a tensor or a list of tensors."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    num = den = 0.0
    for g, w in zip(got, want):
        d = g.double() - w.double()
        num += float((d * d).sum())
        den += float((w.double() ** 2).sum())
    return _rel(num, den)


@torch.no_grad()
def eval_batch(tally: Tally, rec: dict, ref: Reference, pred: Prediction, fitted: Fitted,
               neck: bool = True) -> None:
    """One batch of the program's per-box record against the reference's
    prediction ``pred`` (of its own forward, or, with ``neck`` False, of the
    program's own maps)."""
    if neck:
        for p, r in zip(rec["neck"], pred.neck):
            tally.add_max("neck_rel", _rel_t(p, r))
    cls = pred.anchors.cls.cpu().numpy()
    logits = to_numpy(pred.anchors.logits)
    img = ref.img
    rows = min(len(rec["valid"]), len(pred.kept))  # the program's maps may hold fewer images
    unchecked(tally, rec, rows)
    for i in range(rows):
        n = int(rec["valid"][i].sum())
        anchors = rec["anchor"][i, :n]
        mine, theirs = set(anchors.tolist()), set(pred.kept[i].tolist())
        tally.add_count("keep_diff", len(mine ^ theirs), len(mine | theirs))
        if n == 0:
            continue
        boxes, level, roi, exact = ref.box_taps(pred, i, anchors)
        a = torch.as_tensor(anchors, device=pred.anchors.boxes.device)
        roi_tv, _ = D.taps(pred.neck, i, boxes, level, pred.anchors.local[a], img, outside="zero")
        level = level.cpu().numpy()
        rb = np.clip(to_numpy(boxes), 0, img)
        tally.add_max("box_px", np.abs(rec["boxes"][i, :n] - rb).max())
        tally.add_sq("logits_rel", rec["logits"][i, :n] - logits[i, anchors], logits[i, anchors])
        flips = 0
        for k, a in enumerate(anchors):
            c = ref.channels[level[k]]
            r, e = roi[k], exact[k]
            tally.add_sq("roi_rel", rec["roi"][i, k, :c] - r, r)
            tally.add_sq("roi_rel_torchvision", rec["roi"][i, k, :c] - roi_tv[k], roi_tv[k])
            tally.add_sq("exact_rel", rec["exact"][i, k, :c] - e, e)
            want = fitted.decide(int(cls[i, a]), int(level[k]), logits[i, a], r)
            flips += int(rec["decision"][i, k] != want)
        tally.add_count("decision_flip", flips, n)


def unchecked(tally: Tally, rec: dict, rows: int) -> None:
    """Rows of the record beyond the first ``rows`` have no maps of the
    program's to check them against: every box they kept counts as kept by
    the program alone."""
    for i in range(rows, len(rec["valid"])):
        n = int(rec["valid"][i].sum())
        tally.add_count("keep_diff", max(n, 1), max(n, 1))


STEM_LAYERS = 2  # the program's fused stem (K4) stands for layers 0 and 1


@torch.no_grad()
def layers(tally: Tally, ref: Reference, captured: dict, images: np.ndarray) -> None:
    """Layer by layer from the compared side's own activations: each
    captured top-level layer's output against the float32 reference layer
    on the same input (``layer_rel``, the widest over the layers), and the
    start, the input of layer STEM_LAYERS, against the reference's first
    layers run on the image (``stem_rel``; the program computes them as one
    fused stem)."""
    model = ref.model.model
    start = captured[STEM_LAYERS][0]
    with P.precision("f32"):
        x = ref.images(images[:len(start)])
        for i in range(STEM_LAYERS):
            x = model[i](x)
        tally.add_max("stem_rel", _rel_t(start.float(), x))
        for i in sorted(captured):
            inp, out = captured[i]
            want = model[i](as_f32(inp))
            tally.add_max("layer_rel", _rel_t(as_f32(out), want))


MATCH_PX = 4.0  # half a P3 cell: a served box's partner among the reference's


def served_request(tally: Tally, served: dict, ref: Reference, pred: Prediction, image: int,
                   fitted: Fitted) -> None:
    """One served image's boxes, against the reference's own kept boxes of
    that image: a served box and a reference box of one class pair up when
    no corner lies more than MATCH_PX apart, the closest pairs first; the
    boxes left unpaired on either side count in ``unmatched``."""
    kept = pred.kept[image]
    boxes, level, roi, _ = ref.box_taps(pred, image, kept)
    level = level.cpu().numpy()
    rb = np.clip(to_numpy(boxes), 0, ref.img)
    cls = pred.anchors.cls.cpu().numpy()[image, kept]
    logits = to_numpy(pred.anchors.logits)[image, kept]
    sb, sc = np.asarray(served["boxes"]), np.asarray(served["cls"]).astype(np.int64)
    gap = (np.abs(sb[:, None, :] - rb[None, :, :]).max(-1) if len(sb) and len(rb)
           else np.zeros((len(sb), len(rb))))
    gap = np.where(sc[:, None] == cls[None, :], gap, np.inf)
    matched = flips = 0
    free_s, free_r = np.ones(len(sb), bool), np.ones(len(rb), bool)
    for flat in np.argsort(gap, axis=None, kind="stable"):
        j, k = divmod(int(flat), max(len(rb), 1))
        if gap[j, k] > MATCH_PX:
            break
        if not (free_s[j] and free_r[k]):
            continue
        free_s[j] = free_r[k] = False
        matched += 1
        tally.add_max("box_px", np.abs(sb[j] - rb[k]).max())
        tally.add_sq("logits_rel", served["logits"][j] - logits[k], logits[k])
        want = fitted.decide(int(cls[k]), int(level[k]), logits[k], roi[k])
        flips += int(bool(served["is_ood"][j]) != (want == 0))
    tally.add_count("unmatched", len(sb) + len(rb) - 2 * matched, len(sb) + len(rb))
    tally.add_count("decision_flip", flips, max(matched, 0))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """[{name, value, limit, ok}] for every number, judged where it has a limit."""
    out = []
    for name in sorted(numbers):
        lim = limits.get(name)
        v = numbers[name]
        out.append(dict(name=name, value=v, limit=lim,
                        ok=None if lim is None else bool(np.isfinite(v) and v <= lim)))
    return out
