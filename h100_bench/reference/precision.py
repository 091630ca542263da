"""Arithmetic precision of the plain reference.

The reference computes in float32 with TF32 off. The correctness control
puts the same reference in the program's place at the precision one step
below the configuration's (``control_mode``): TF32 for a float32 cell, fp8
(e4m3) for a bfloat16 cell. Both are emulated by rounding the operands of
every convolution and matrix product before an f32 product, which is what
the tensor cores do with them, so the control reads the same on the card
and on the CPU. In a backward pass the gradients those products take are
rounded as well.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
FP8_MAX = 448.0  # largest finite float8_e4m3fn
_mode = "f32"


def control_mode(dtype: str) -> str:
    """The precision below the configuration's: tf32 under float32, fp8 under bfloat16."""
    return {"float32": "tf32", "bfloat16": "fp8"}[dtype]


@contextlib.contextmanager
def precision(mode: str):
    global _mode
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode}")
    old, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest value with a 10-bit mantissa (ties away from zero), as f32."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled e4m3 rounding, as f32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _round(x: torch.Tensor) -> torch.Tensor:
    return round_tf32(x) if _mode == "tf32" else round_fp8(x)


class _Operand(torch.autograd.Function):
    """Rounded forward; the gradient flowing back to it rounded too."""

    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


class _Result(torch.autograd.Function):
    """The forward as it is (fp8 mode stores it in bf16); the gradient
    arriving at a product's output rounded, as the backward's products take
    it as an operand."""

    @staticmethod
    def forward(ctx, y):
        return y.to(torch.bfloat16).float() if _mode == "fp8" else y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def operand(x: torch.Tensor) -> torch.Tensor:
    """A product's operand at this precision (f32: as it is)."""
    x = x.float()
    return x if _mode == "f32" else _Operand.apply(x)


def result(y: torch.Tensor) -> torch.Tensor:
    """A product's result: fp8 mode stores activations in bf16."""
    return y if _mode == "f32" else _Result.apply(y)


def conv2d(x, w, b=None, stride=1, padding=0, groups=1):
    y = F.conv2d(operand(x), operand(w), None, stride, padding, 1, groups)
    if b is not None:
        y = y + b.float()[:, None, None]
    return result(y)


def matmul(a, b):
    return result(torch.matmul(operand(a), operand(b)))
