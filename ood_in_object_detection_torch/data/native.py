"""ctypes bindings to the native (C++) letterbox preprocessor.

The library is built on demand from native/letterbox.cpp; callers fall back
to the NumPy/PIL path transparently when a toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .letterbox import letterbox_params, PAD_VALUE

log = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _NATIVE_DIR / "libletterbox.so"
    if not so.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:  # no toolchain: numpy fallback
            log.info("native letterbox unavailable (%s); using NumPy path", e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.letterbox_u8_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
        ]
        _LIB = lib
    except OSError as e:
        log.info("native letterbox failed to load: %s", e)
    return _LIB


def native_available() -> bool:
    return _load() is not None


def letterbox_into(img: np.ndarray, dst: np.ndarray, img_size: int):
    """Letterbox HWC uint8 ``img`` into preallocated f32 ``dst``
    (img_size, img_size, C), returning ratio_pad. Uses the native kernel when
    available, else NumPy/PIL."""
    h, w = img.shape[:2]
    r, (uw, uh), (dw, dh) = letterbox_params(h, w, (img_size, img_size))
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    lib = _load()
    if lib is not None and img.flags["C_CONTIGUOUS"]:
        lib.letterbox_u8_to_f32(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w, img.shape[2],
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            img_size, uh, uw, top, left, float(PAD_VALUE),
        )
    else:
        from .letterbox import letterbox_np

        out, _ = letterbox_np(img, (img_size, img_size))
        dst[:] = out.astype(np.float32) / 255.0
    return (r, r), (dw, dh)
