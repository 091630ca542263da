"""The stem probe ladder's three functions, and the wrappers of their kernels.

Port of the eight ``pl.pallas_call`` sites of scripts/bench_stem_parts.py,
bench_stem_parts2.py, bench_stem_parts3.py and bench_stem_parts4.py: rungs of
one ladder that bisects the phase-folded stem on its space-to-depth layout,
z (B, H(+2), W, 48) bf16 -> (B, H, W, 32) bf16. Each Pallas kernel computes
one of three functions, whatever its tiling:

- :func:`window_copy_plain`: ``z[:, row0:, :, :cout]``, the IO
  rungs (P1 and P8 ``io``, P2, P3, P5, P6, P7);
- :func:`shift_add_plain`: ``(z + zx)[:, 2:, :, :32]`` rounded to bf16, zx
  being z moved ``shift`` pixels along each tile's flattened (row, column)
  order with column 0 zeroed (P4; its ``bitcast_roll`` mode moves two
  pixels, the others one);
- :func:`stem_gemm_plain`: the GEMM rungs of P1 (``mm*``) and P8
  (``halo_*``), one or two bf16 products with f32 sums and SiLU.

The plain versions compute in f32 and round to bf16 where the Pallas kernels
round: the bf16 add of the shift, h1 after SiLU, the output. The wrappers
:func:`window_copy`, :func:`shift_add` and :func:`stem_gemm` run the plain
version for CPU tensors and launch the CUDA kernel (``csrc/stem_parts_copy.cu``,
``stem_parts_shift.cu``, ``stem_parts_mm.cu``) for CUDA tensors, counting
launches.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

CIN, COUT = 48, 32   # the space-to-depth stem's channels in and out
# GEMM modes: ladder 1 (bench_stem_parts.py kernel bodies) and ladder 4
# (bench_stem_parts4.py make(mode)); the index is the kernel's mode number
GEMM_MODES = ("mm", "mm_shift", "mm_concat", "mm_accum",
              "halo_mm_pad", "halo_mm_concat", "halo_full_noshift", "halo_full")
# the weights each mode reads, as the scripts name them
GEMM_WEIGHTS = {"mm": ("w48", "w64"), "mm_shift": ("w48", "w64"), "mm_concat": ("w1", "w64"),
                "mm_accum": ("w48", "w64"), "halo_mm_pad": ("w1",), "halo_mm_concat": ("w1",),
                "halo_full_noshift": ("w1", "w2"), "halo_full": ("w1", "w2")}
# rows of output in each work item of the GEMM kernel (its row tile)
GEMM_ROWS_PER_ITEM = 40
# csrc/stem_parts_mm.cu's schedule: pixels of a column strip (the wgmma M),
# warpgroups a block, z rows in each warpgroup's TMA ring
GEMM_STRIP, GEMM_WARPGROUPS, GEMM_STAGES = 64, 4, 4
# the weight images' shapes, (K, N) in the kernel's K order
GEMM_IMAGE_SHAPES = {"w48": (CIN, 64), "w64": (64, COUT), "w1": (128, 64), "w2": (192, COUT)}


def window_copy_plain(z: torch.Tensor, row0: int = 2, cout: int = COUT) -> torch.Tensor:
    """(B, Hin, W, Cin) -> (B, Hin - row0, W, cout) = z[:, row0:, :, :cout]."""
    return z[:, row0:, :, :cout].contiguous()


def _shifted(z: torch.Tensor, shift: int) -> torch.Tensor:
    """z moved ``shift`` pixels along each tile's flattened (row, column)
    order, the first ``shift`` positions and column 0 zeroed."""
    n, r, w, c = z.shape
    flat = z.reshape(n, r * w, c)
    zx = F.pad(flat[:, :-shift], (0, 0, shift, 0)).reshape(n, r, w, c).clone()
    zx[:, :, 0] = 0
    return zx


def shift_add_plain(z: torch.Tensor, shift: int) -> torch.Tensor:
    """(N, R, W, C) tiles -> (N, R - 2, W, 32): ``(z + zx)[:, 2:, :, :32]``
    with the add rounded once (bench_stem_parts2.py:shift_bench)."""
    zx = _shifted(z[..., :COUT], shift)
    return (z[:, 2:, :, :COUT].float() + zx[:, 2:].float()).to(z.dtype)


def _shift1(t: torch.Tensor) -> torch.Tensor:
    """t[:, :, x - 1], zero at x = 0 (the one-pixel shift within each row)."""
    return F.pad(t[:, :, :-1], (0, 0, 1, 0))


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 product of bf16 operands (preferred_element_type=f32)."""
    return a.float() @ w.float()


def _act(acc: torch.Tensor) -> torch.Tensor:
    """SiLU in f32, rounded to bf16."""
    return F.silu(acc).to(torch.bfloat16)


def _union(cur: torch.Tensor, prev: torch.Tensor, shift: bool) -> torch.Tensor:
    """The 128-lane union-tap operand: [z, zx, z_prev[36:48], zx_prev[36:48],
    0 x 8], zx the one-pixel shift (or z itself when ``shift`` is false)."""
    sh = _shift1 if shift else (lambda t: t)
    zero = cur.new_zeros(*cur.shape[:3], 8)
    return torch.cat([cur, sh(cur), prev[..., 36:48], sh(prev)[..., 36:48], zero], -1)


def stem_gemm_plain(z: torch.Tensor, weights: Dict[str, torch.Tensor], mode: str) -> torch.Tensor:
    """The GEMM rungs: z (B, H + 2, W, 48) for ladder 1's modes, (B, H, W, 48)
    for the ``halo_*`` modes -> (B, H, W, 32) bf16.

    Row y of the output reads rows y + 2 (``base``), y + 1 (``prev``) and y
    (``prev2``) of zp, which is z for ladder 1 and z under two zero rows for
    the halo modes (bench_stem_parts4.py's halo block: rows t*TH - 2 and
    t*TH - 1 of z above each row tile, zeros above the first)."""
    if mode not in GEMM_MODES:
        raise ValueError(f"stem_gemm: mode {mode!r} is none of {GEMM_MODES}")
    w = weights
    zp = F.pad(z, (0, 0, 0, 0, 2, 0)) if mode.startswith("halo") else z
    h = zp.shape[1] - 2
    base, prev, prev2 = zp[:, 2:2 + h], zp[:, 1:1 + h], zp[:, :h]
    if mode == "mm":
        h1 = _act(_dot(base, w["w48"]))
    elif mode == "mm_shift":
        h1 = _act(_dot((base.float() + _shift1(base).float()).to(z.dtype), w["w48"]))
    elif mode == "mm_concat":
        h1 = _act(_dot(_union(base, prev, shift=False), w["w1"]))
    elif mode == "mm_accum":
        w48 = w["w48"]
        h1 = _act(_dot(base, w48) + _dot(_shift1(base), w48) + _dot(prev2, w48)
                  + _dot(_shift1(prev2), w48))
    elif mode == "halo_mm_pad":
        return _act(_dot(base, w["w1"][:CIN, :COUT]))
    elif mode == "halo_mm_concat":
        return _act(_dot(_union(base, prev, shift=False), w["w1"][:, :COUT]))
    else:  # halo_full_noshift, halo_full: h1 on rows y and y - 1, then v
        shift = mode == "halo_full"
        h1all = _act(_dot(_union(zp[:, 1:], zp[:, :-1], shift), w["w1"]))  # rows -1 .. H-1
        cur, prv = h1all[:, 1:], h1all[:, :-1]
        v = torch.cat([cur, cur, prv[..., 32:64], prv[..., 32:64]], -1)
        return _act(_dot(v, w["w2"]))
    return _act(_dot(h1, w["w64"]))


def gemm_chunks(mode: str):
    """The GEMM kernel's first operand, 8 channels a chunk: (dr, sh, ch) reads
    padded-z row y + dr, pixel x - sh, channels ch .. ch + 7 (csrc/stem_parts_mm.cu
    ``chunk<M>``). The union modes take channels 32:48 of the prev taps where
    the Pallas kernels take 36:48 and 8 zero lanes (see :data:`W1_KERNEL_ROWS`)."""
    if mode in ("mm", "mm_shift", "halo_mm_pad"):
        return [(2, 0, 8 * c) for c in range(6)]
    if mode == "mm_accum":
        return [(2 if c < 12 else 0, (c // 6) & 1, 8 * (c % 6)) for c in range(24)]
    sh = 1 if mode == "halo_full" else 0
    return ([(2, 0, 8 * c) for c in range(6)] + [(2, sh, 8 * c) for c in range(6)]
            + [(1, 0, 32 + 8 * c) for c in range(2)] + [(1, sh, 32 + 8 * c) for c in range(2)])


def _w1_kernel_rows():
    rows = list(range(96))
    for first in (96, 108):    # prev[36:48], zx_prev[36:48] in the Pallas union
        rows += [-1] * 4 + list(range(first, first + 12))
    return tuple(rows)


# w1's row (the Pallas union's lane) of each of the kernel's 128 K rows; -1:
# a zero row, against channels 32:36 of a prev tap. w1's rows 120:128 face the
# union's 8 zero lanes: no K row reads them.
W1_KERNEL_ROWS = _w1_kernel_rows()


def gemm_image_offsets(k: int, n: int) -> torch.Tensor:
    """(K, N) -> the element offset of B[k, n] in a weight image: per 16-row
    k-step, per 8 columns, per 8-row half of the k-step, an 8 x 8 core
    matrix with k contiguous (wgmma's K-major layout without swizzle: 128
    bytes between the two halves, 256 between column groups)."""
    kk = torch.arange(k)[:, None]
    nn = torch.arange(n)[None, :]
    return (((kk // 16 * (n // 8) + nn // 8) * 2 + kk // 8 % 2) * 64 + nn % 8 * 8 + kk % 8)


@functools.lru_cache(maxsize=None)
def _image_index(name: str) -> torch.Tensor:
    """Gather index of a weight image into ``cat([w.flatten(), 0])``."""
    k, n = GEMM_IMAGE_SHAPES[name]
    rows = torch.tensor(W1_KERNEL_ROWS if name == "w1" else tuple(range(k)))
    src = torch.where(rows[:, None] >= 0, rows[:, None] * n + torch.arange(n), k * n)
    index = torch.empty(k * n, dtype=torch.long)
    index[gemm_image_offsets(k, n).flatten()] = src.flatten()
    return index


_DEVICE_INDEX: dict = {}


def pack_gemm_weight(w: torch.Tensor, name: str) -> torch.Tensor:
    """A weight (w48, w64, w1 or w2, the scripts' shapes) as the GEMM kernel's
    shared-memory image, flat, on w's device: rows in the kernel's K order
    (:data:`W1_KERNEL_ROWS` for w1), laid out by :func:`gemm_image_offsets`."""
    key = (name, str(w.device))
    index = _DEVICE_INDEX.get(key)
    if index is None:
        index = _DEVICE_INDEX[key] = _image_index(name).to(w.device)
    return torch.cat([w.reshape(-1), w.new_zeros(1)])[index]


def unpack_gemm_weight(image: torch.Tensor, name: str) -> torch.Tensor:
    """The inverse of :func:`pack_gemm_weight` on the rows the kernel reads:
    w1's rows 120:128, which no K row reads, come back as zeros."""
    k, n = GEMM_IMAGE_SHAPES[name]
    kernel_order = image[gemm_image_offsets(k, n)]        # (K, N) in the kernel's K order
    if name != "w1":
        return kernel_order
    rows = torch.tensor(W1_KERNEL_ROWS)
    out = image.new_zeros(128, n)
    out[rows[rows >= 0]] = kernel_order[rows >= 0]
    return out


def gemm_plan(mode: str, batch: int, hin: int, w: int, rows: int = GEMM_ROWS_PER_ITEM,
              sms: int = 132):
    """The GEMM kernel's schedule (csrc/stem_parts_mm.cu ``item_at`` and its
    launch): -> one list per warpgroup of its items in order, each
    {b, x0, y0, y1, h_rows, z_rows}: output rows y0 .. y1 - 1 of pixels x0 ..
    x0 + 63, the h1 rows computed (one above the tile in the full modes) and
    the z rows its ring loads, end exclusive (outside z: TMA's zeros)."""
    halo = mode.startswith("halo")
    full = mode in ("halo_full_noshift", "halo_full")
    pad, extra = (2 if halo else 0), (1 if full else 0)
    lo = min(dr for dr, _, _ in gemm_chunks(mode))
    hout = hin + pad - 2
    tiles, strips = -(-hout // rows), -(-w // GEMM_STRIP)
    items = batch * tiles * strips
    stride = min(-(-items // GEMM_WARPGROUPS), sms) * GEMM_WARPGROUPS
    plan = []
    for q in range(min(stride, items)):
        mine = []
        for i in range(q, items, stride):
            s, r = divmod(i, batch * tiles)
            b, t = divmod(r, tiles)
            y0 = t * rows
            y1 = min(y0 + rows, hout)
            mine.append(dict(b=b, x0=s * GEMM_STRIP, y0=y0, y1=y1, h_rows=(y0 - extra, y1),
                             z_rows=(y0 - extra + lo - pad, y1 + 2 - pad)))
        plan.append(mine)
    return plan


def _check_bf16(name: str, **tensors) -> None:
    from .kernels import _build

    _build.require_cuda(name, **tensors)
    for arg, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} must be bf16, got {t.dtype}")


def window_copy(z: torch.Tensor, row0: int = 2, cout: int = COUT) -> torch.Tensor:
    """``z[:, row0:, :, :cout]`` of a (B, Hin, W, Cin) tensor.

    Replaces the IO kernels of scripts/bench_stem_parts{,2,3,4}.py. CUDA
    tensors launch csrc/stem_parts_copy.cu (bf16, Cin and cout multiples of
    8); CPU tensors take :func:`window_copy_plain`."""
    if z.dim() != 4:
        raise ValueError(f"window_copy: z must be (B, Hin, W, Cin), got {tuple(z.shape)}")
    b, hin, wp, cin = z.shape
    if not 0 <= row0 < hin or not 0 < cout <= cin:
        raise ValueError(f"window_copy: rows {row0}:, channels :{cout} outside z "
                         f"{tuple(z.shape)}")
    if z.device.type == "cpu":
        return window_copy_plain(z, row0, cout)
    from .kernels import _build

    _check_bf16("window_copy", z=z)
    if cin % 8 or cout % 8:
        raise ValueError(f"window_copy: the kernel copies 16-byte groups, Cin={cin} and "
                         f"cout={cout} must be multiples of 8")
    out = torch.empty((b, hin - row0, wp, cout), dtype=z.dtype, device=z.device)
    code = _build.launcher("stem_parts_copy")(
        z.data_ptr(), out.data_ptr(), b, hin, wp, cin, row0, hin - row0, cout,
        _build.stream_handle(z.device))
    _build.count_launch(window_copy)
    _build.check_launch("stem_parts_copy", code)
    return out


window_copy.launches = 0


def shift_add(z: torch.Tensor, shift: int) -> torch.Tensor:
    """``(z + zx)[:, 2:, :, :32]`` of (N, R, W, C) tiles, zx moved ``shift``
    pixels (1 or 2) along each tile's flattened row order, column 0 zeroed.

    Replaces bench_stem_parts2.py:shift_bench (shift 1: ``concat`` and
    ``f32_roll``; shift 2: ``bitcast_roll``). CUDA tensors launch
    csrc/stem_parts_shift.cu; CPU tensors take :func:`shift_add_plain`."""
    if z.dim() != 4 or z.shape[1] < 3 or shift not in (1, 2) or z.shape[3] < COUT:
        raise ValueError(f"shift_add: (N, R >= 3, W, C >= {COUT}) tiles and shift 1 or 2; "
                         f"got {tuple(z.shape)}, shift {shift}")
    if z.device.type == "cpu":
        return shift_add_plain(z, shift)
    from .kernels import _build

    _check_bf16("shift_add", z=z)
    n, r, w, c = z.shape
    if c % 8:
        raise ValueError(f"shift_add: C={c} must be a multiple of 8")
    out = torch.empty((n, r - 2, w, COUT), dtype=z.dtype, device=z.device)
    code = _build.launcher("stem_parts_shift")(
        z.data_ptr(), out.data_ptr(), n, r, w, c, shift, COUT, _build.stream_handle(z.device))
    _build.count_launch(shift_add)
    _build.check_launch("stem_parts_shift", code)
    return out


shift_add.launches = 0


def stem_gemm(z: torch.Tensor, weights: Dict[str, torch.Tensor], mode: str) -> torch.Tensor:
    """One GEMM rung of the stem ladder (:data:`GEMM_MODES`), z (B, H + 2, W,
    48) for ladder 1's modes or (B, H, W, 48) for the halo modes -> (B, H, W,
    32) bf16. ``weights`` holds the scripts' names (:data:`GEMM_WEIGHTS`):
    w48 (48, 64), w64 (64, 32), w1 (128, 64), w2 (192, 32).

    Replaces the GEMM kernel bodies of scripts/bench_stem_parts.py and
    bench_stem_parts4.py:make. CUDA tensors launch csrc/stem_parts_mm.cu
    (TMA row ring, wgmma with f32 sums, h1 kept in registers) on the weights
    packed by :func:`pack_gemm_weight`; z must be 16-byte aligned. CPU
    tensors take :func:`stem_gemm_plain`."""
    if mode not in GEMM_MODES:
        raise ValueError(f"stem_gemm: mode {mode!r} is none of {GEMM_MODES}")
    names = GEMM_WEIGHTS[mode]
    for k in names:
        if k not in weights or tuple(weights[k].shape) != GEMM_IMAGE_SHAPES[k]:
            raise ValueError(f"stem_gemm {mode}: needs {k} of shape {GEMM_IMAGE_SHAPES[k]}")
    halo = mode.startswith("halo")
    if z.dim() != 4 or z.shape[3] != CIN or z.shape[1] < (1 if halo else 3):
        raise ValueError(f"stem_gemm: z must be (B, H{'' if halo else ' + 2'}, W, {CIN}), "
                         f"got {tuple(z.shape)}")
    if z.device.type == "cpu":
        return stem_gemm_plain(z, weights, mode)
    from .kernels import _build

    w1 = weights[names[0]]
    w2 = weights[names[1]] if len(names) > 1 else None
    _check_bf16("stem_gemm", z=z, w1=w1, **({} if w2 is None else {"w2": w2}))
    if z.data_ptr() % 16:
        raise ValueError("stem_gemm: z must be 16-byte aligned (the kernel reads it by TMA)")
    b, hin, w, _ = z.shape
    hout = hin if halo else hin - 2
    out = torch.empty((b, hout, w, COUT), dtype=z.dtype, device=z.device)
    b1 = pack_gemm_weight(w1, names[0])
    b2 = None if w2 is None else pack_gemm_weight(w2, names[1])
    code = _build.launcher("stem_parts_mm")(
        z.data_ptr(), b1.data_ptr(), 0 if b2 is None else b2.data_ptr(),
        GEMM_MODES.index(mode), b, hin, w, GEMM_ROWS_PER_ITEM, out.data_ptr(),
        _build.stream_handle(z.device))
    _build.count_launch(stem_gemm)
    _build.check_launch("stem_parts_mm", code)
    return out


stem_gemm.launches = 0
