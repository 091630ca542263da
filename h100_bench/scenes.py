"""Seeded inputs: scenes, their labels, request arrivals.

``make_scenes`` follows ``chip_smoke.py:make_scenes`` (a background colour,
3-8 discs of random colour and size, sensor noise of a random level), made
on the device from a ``torch.Generator`` in a few large draws.
``label_batches`` follows ``chip_smoke.py:label_batches``: the ground
truth of an InD batch is the detector's own most confident boxes.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

MAX_DISCS = 8


def make_scenes(gen: torch.Generator, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) uint8 scenes drawn from ``gen`` on its device."""
    return _paint(_draw(gen, n, size), size).to(torch.uint8).cpu().numpy()


def make_train_batch(gen: torch.Generator, n: int, size: int, nc: int, max_gt: int) -> dict:
    """A training batch on ``gen``'s device: n scenes as (n, 3, size, size)
    f32 in [0, 1], each disc's bounding box (clipped to the image) its
    ground truth, of a class drawn from ``gen``, padded to ``max_gt`` boxes."""
    d = _draw(gen, n, size)
    img = _paint(d, size).to(torch.uint8).float() / 255.0
    labels = torch.randint(0, nc, (n, MAX_DISCS), generator=gen, device=gen.device)
    c, r = d["centre"], d["radius"][..., None]
    boxes = torch.cat([c - r, c + r], -1).clamp(0, size)
    mask = torch.arange(MAX_DISCS, device=gen.device)[None] < d["discs"][:, None]
    pad = max_gt - MAX_DISCS
    return dict(images=img.permute(0, 3, 1, 2).contiguous(),
                gt_labels=torch.nn.functional.pad(labels * mask, (0, pad)),
                gt_bboxes=torch.nn.functional.pad(boxes * mask[..., None], (0, 0, 0, pad)),
                gt_mask=torch.nn.functional.pad(mask, (0, pad)))


def _draw(gen: torch.Generator, n: int, size: int) -> dict:
    dev = gen.device
    d = dict(bg=torch.rand(n, 1, 1, 3, generator=gen, device=dev) * 255,
             discs=torch.randint(3, MAX_DISCS + 1, (n,), generator=gen, device=dev),
             centre=torch.rand(n, MAX_DISCS, 2, generator=gen, device=dev) * size)
    d["radius"] = (torch.rand(n, MAX_DISCS, generator=gen, device=dev) * (1 / 5 - 1 / 30)
                   + 1 / 30) * size
    d["colour"] = torch.rand(n, MAX_DISCS, 3, generator=gen, device=dev) * 255
    d["level"] = torch.rand(n, 1, 1, 1, generator=gen, device=dev) * 38 + 2
    d["noise"] = torch.randn(n, size, size, 3, generator=gen, device=dev)
    return d


def _paint(d: dict, size: int) -> torch.Tensor:
    """(n, size, size, 3) f32 in [0, 255]: later discs over earlier ones."""
    dev = d["bg"].device
    n = d["bg"].shape[0]
    yy, xx = torch.meshgrid(torch.arange(size, device=dev, dtype=torch.float32),
                            torch.arange(size, device=dev, dtype=torch.float32), indexing="ij")
    img = d["bg"].expand(n, size, size, 3).clone()
    for k in range(MAX_DISCS):
        cx, cy = d["centre"][:, k, 0, None, None], d["centre"][:, k, 1, None, None]
        r = d["radius"][:, k, None, None]
        inside = ((xx - cx) ** 2 + (yy - cy) ** 2 < r * r) & (k < d["discs"])[:, None, None]
        img = torch.where(inside[..., None], d["colour"][:, k, None, None, :], img)
    return (img + d["noise"] * d["level"]).clamp(0, 255)


def label_batches(predict: Callable, batches: List[np.ndarray], conf: float, max_gt: int,
                  nc: int) -> List[dict]:
    """Batch dicts whose ground truth is ``predict``'s own top ``max_gt``
    boxes an image; ``predict(images) -> (boxes, cls, valid)`` numpy."""
    out = []
    for bi, imgs in enumerate(batches):
        boxes, cls, valid = predict(imgs)
        b = len(imgs)
        gtb = np.zeros((b, max_gt, 4), np.float32)
        gtc = np.zeros((b, max_gt), np.int32)
        gtm = np.zeros((b, max_gt), bool)
        for i in range(b):
            n = min(int(valid[i].sum()), max_gt)
            gtb[i, :n], gtc[i, :n], gtm[i, :n] = boxes[i, :n], cls[i, :n], True
        out.append(dict(images=imgs, gt_bboxes=gtb, gt_labels=gtc, gt_mask=gtm,
                        im_names=[f"b{bi}_{i}" for i in range(b)],
                        ratio_pad=[((1.0, 1.0), (0.0, 0.0))] * b))
    return out


def poisson_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Open-loop send times in [0, seconds): ``n = rate * seconds`` gaps at
    the exponential distribution's n quantiles (stratified), in an order
    drawn from ``seed``. Every seed gets the same set of gaps, so runs
    differ in the order of the bursts and not in the offered load."""
    n = int(math.floor(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.permutation(gaps))
    return t[t < seconds]
