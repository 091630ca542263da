"""Arithmetic the per-layer readers share: model FLOP utilisation, the
device's idle share, and the least time of the kernels' work from their
shapes (``roofline.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from h100_bench import flops, roofline
from h100_bench.reference import detect


def step_mfu_pct(cell, outcome, flops_per_image: float) -> Optional[float]:
    s = outcome.summary
    images = outcome.layer.get("traced_images", 0)
    if s is None or not images or s.window_s <= 0:
        return None
    peak = roofline.PEAK_OPS[outcome.layer["dtype"]]
    return 100.0 * flops_per_image * images / s.window_s / peak


def idle_pct(outcome) -> Optional[float]:
    s = outcome.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def span_roofline_pct(outcome, name: str, least_s) -> Optional[float]:
    """Least time over measured device time, summed over the span's calls
    in the traced window; None when the profiler gave no device records."""
    s = outcome.summary
    calls = [] if s is None else [c for c in s.spans.get(name, []) if c["info"] is not None]
    dev = sum(c["device_s"] for c in calls)
    if not calls or dev <= 0 or any(c["kernels"] == 0 for c in calls):
        return None
    return 100.0 * sum(least_s(c["info"]) for c in calls) / dev


def stem_least_s(info: dict) -> float:
    """The two k3/s2 convolutions of the stem: the image in and the second
    conv's map out once, the weights once; 2 x multiply-adds of both convs."""
    b, cin, h, w = info["x"]
    c1, c2 = info["w1"][0], info["w2"][0]
    size = roofline.DTYPE_BYTES[info["dtype"]]
    h1, w1, h2, w2 = h // 2, w // 2, h // 4, w // 4
    ops = 2.0 * b * (h1 * w1 * c1 * cin * 9 + h2 * w2 * c2 * c1 * 9)
    moved = size * (b * cin * h * w + b * c2 * h2 * w2) + 4 * (c1 * cin * 9 + c2 * c1 * 9)
    return roofline.bound(moved, ops, info["dtype"])["bound_s"]


def roi_least_s(info: dict) -> float:
    """The RoI and exact taps of every box row: the map cells some row's
    bilinear samples (or its exact cell) touch, read once an image and
    level, the two outputs written once; 2 operations a touched cell and
    channel a row."""
    import torch

    boxes = info["boxes"].float()
    level = info["level"]
    anchor = info["anchor"]
    moved = sum(np.prod(shape) * size for shape, size in info["out"]) + 12.0 * boxes.numel()
    ops = 0.0
    dtype = None
    offset = 0
    for li, (shape, dt) in enumerate(info["maps"]):
        dtype = dt
        b, h, w, c = shape
        mine = level == li
        scale = w / info["img_w"]
        bx = boxes * scale
        x0, y0 = bx[..., 0].reshape(-1), bx[..., 1].reshape(-1)
        wx = detect._axis_taps(x0, torch.clamp(bx[..., 2].reshape(-1) - x0, min=1.0), w)
        wy = detect._axis_taps(y0, torch.clamp(bx[..., 3].reshape(-1) - y0, min=1.0), h)
        rows = (wy > 0).reshape(b, -1, h)
        cols = (wx > 0).reshape(b, -1, w)
        sel = mine.reshape(b, -1)
        touched = torch.einsum("bnh,bnw->bhw", (rows & sel[..., None]).float(),
                               (cols & sel[..., None]).float()) > 0
        local = torch.clamp(anchor - offset, 0, h * w - 1)
        here = (anchor >= offset) & (anchor < offset + h * w)
        exact = torch.zeros(b, h * w, dtype=torch.bool, device=boxes.device)
        exact.scatter_(1, local, here)
        cells = (touched.reshape(b, -1) | exact).sum().item()
        size = roofline.DTYPE_BYTES[dt]
        moved += cells * c * size
        ops += 2.0 * c * (float((rows.sum(-1) * cols.sum(-1) * sel).sum().item()) + float(here.sum().item()))
        offset += h * w
    return roofline.bound(moved, ops, dtype)["bound_s"]
