"""Letterbox preprocessing (resize + pad) with ratio_pad bookkeeping.

Semantics parity with the reference LetterBox transform
(ultralytics/data/augment.py LetterBox, engine/predictor.py:175-194):

- scale r = min(new_h/h, new_w/w) (no upscale when scaleup=False)
- pad to target with value 114, padding split evenly (dw/2, dh/2)
- ``ratio_pad = ((r, r), (dw, dh))`` is carried with every image — the EUL
  unknown-localization pass divides the pad by the stride to unpad feature
  maps (reference ood_utils.py:686-695), so off-by-ones here shift all
  unknown boxes.

The NumPy/PIL host path of ood_in_object_detection_tpu/data/letterbox.py,
copied unchanged (its JAX path, letterbox_jax, is not needed by the port).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PAD_VALUE = 114


def letterbox_params(h: int, w: int, new_shape: Tuple[int, int], scaleup: bool = True):
    """-> (r, (new_w, new_h), (dw, dh)) with dw/dh the *total* pad halves."""
    nh, nw = new_shape
    r = min(nh / h, nw / w)
    if not scaleup:
        r = min(r, 1.0)
    uw, uh = round(w * r), round(h * r)
    dw, dh = (nw - uw) / 2, (nh - uh) / 2
    return r, (uw, uh), (dw, dh)


def letterbox_np(img: np.ndarray, new_shape: Tuple[int, int] = (640, 640),
                 scaleup: bool = True):
    """HWC uint8 -> (letterboxed HWC uint8, ratio_pad ((r, r), (dw, dh)))."""
    from PIL import Image

    h, w = img.shape[:2]
    r, (uw, uh), (dw, dh) = letterbox_params(h, w, new_shape, scaleup)
    if (uw, uh) != (w, h):
        img = np.asarray(Image.fromarray(img).resize((uw, uh), Image.BILINEAR))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), PAD_VALUE, img.dtype)
    out[top : top + uh, left : left + uw] = img
    return out, ((r, r), (dw, dh))


def scale_boxes_back(boxes_xyxy: np.ndarray, ratio_pad, orig_hw: Tuple[int, int]) -> np.ndarray:
    """Map boxes from letterboxed space back to original image pixels
    (reference utils/ops.py scale_boxes)."""
    (r, _), (dw, dh) = ratio_pad
    out = boxes_xyxy.copy().astype(np.float64)
    out[..., [0, 2]] -= dw
    out[..., [1, 3]] -= dh
    out /= r
    h, w = orig_hw
    out[..., [0, 2]] = out[..., [0, 2]].clip(0, w)
    out[..., [1, 3]] = out[..., [1, 3]].clip(0, h)
    return out
