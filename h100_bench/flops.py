"""Forward FLOPs of a configuration, counted from its layer shapes.

The reference model (``reference/model.py``) is built from the
configuration on the ``meta`` device and run on a meta image: every
convolution adds 2 x its multiply-adds, every matrix product of the area
attention adds 2 x its multiply-adds, whatever implements them in the
program. Nothing is allocated or computed. A training step counts 3 x the
forward (the forward, and the backward's two products a layer).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .reference import model as M
from .reference import precision as P


@contextlib.contextmanager
def _counting(totals: dict):
    conv, matmul = P.conv2d, P.matmul

    def count_conv(x, w, b=None, stride=1, padding=0, groups=1):
        y = conv(x, w, b, stride, padding, groups)
        totals["conv"] += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def count_matmul(a, b):
        y = matmul(a, b)
        totals["attention"] += 2 * y.numel() * a.shape[-1]
        return y

    P.conv2d, P.matmul = count_conv, count_matmul
    try:
        yield
    finally:
        P.conv2d, P.matmul = conv, matmul


def _freeze(cfg: dict) -> str:
    import json

    return json.dumps(cfg, sort_keys=True)


@functools.lru_cache(maxsize=16)
def _forward_parts(cfg_json: str, img: int) -> tuple:
    import json

    cfg = json.loads(cfg_json)
    totals = {"conv": 0, "attention": 0}
    with torch.device("meta"):
        model = M.YOLO(cfg).eval()
        x = torch.empty(1, 3, img, img)
        with _counting(totals), torch.no_grad():
            model(x)
    return totals["conv"], totals["attention"]


def forward_parts(cfg: dict, img: int = None) -> dict:
    """{'conv': FLOPs, 'attention': FLOPs} of one image's forward."""
    conv, attn = _forward_parts(_freeze(cfg), int(img or cfg["img_size"]))
    return {"conv": conv, "attention": attn}


def forward_flops(cfg: dict, img: int = None) -> int:
    parts = forward_parts(cfg, img)
    return parts["conv"] + parts["attention"]


def train_flops(cfg: dict, img: int = None) -> int:
    return 3 * forward_flops(cfg, img)
