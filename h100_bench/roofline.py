"""The card's peaks and the least time a piece of work can take on it.

Copied from ``chip_smoke.py`` (``bound``, ``nbytes``, ``HBM_BYTES_PER_S``,
``PEAK_OPS``). Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet, dense
rates at the 700 W power limit: 3.35 TB/s of HBM, 67 TFLOP/s in float32
outside the tensor cores (the program's float32 runs with TF32 off), 989
TFLOP/s in bfloat16. A share is stated against these peaks with the card's
power limit beside it (``nvidia-smi``, on an earlier line of every run).
Bytes and operations are counted from the problem's shapes: each input
byte read once, each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def bound(bytes_moved: float, ops: float, dtype: str) -> dict:
    """The least seconds: bytes over HBM bandwidth or operations over the
    dtype's peak, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return dict(bound_s=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
