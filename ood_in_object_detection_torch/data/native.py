"""ctypes bindings to the native (C++) letterbox preprocessor.

The library is built on demand from native/letterbox.cpp; callers fall back
to the NumPy/PIL path transparently when a toolchain is unavailable.

Unlike the JAX package's copy, the first load runs under a lock and marks
itself done only once the library is loaded or refused: PaddedBatcher's
decode threads call ``_load`` together, and the unlocked copy let the
threads that came while another was still loading take the NumPy path, so
a process's first batch mixed the two letterboxes (``/ 255.0`` against
``* (1.0f / 255.0f)``, 6e-8 apart).
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .letterbox import letterbox_params, PAD_VALUE

log = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            _load_locked()
            _TRIED = True
    return _LIB


def _load_locked() -> None:
    """Build (if needed) and load the library into ``_LIB``; leaves it None
    where there is no toolchain or the load fails."""
    global _LIB
    so = _NATIVE_DIR / "libletterbox.so"
    if not so.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:  # no toolchain: numpy fallback
            log.info("native letterbox unavailable (%s); using NumPy path", e)
            return
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
