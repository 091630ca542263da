"""The stem probe ladder on the card: the rungs of
scripts/bench_stem_parts.py, bench_stem_parts2.py, bench_stem_parts3.py and
bench_stem_parts4.py (ladders 1-4), each through the port's kernel.

    python -m ood_in_object_detection_torch.scripts.bench_stem_parts [--ladder 1|2|3|4|all]
        [--device cuda|cpu] [--batch 128 --height 160 --width 160]

The ladder bisects the phase-folded stem on its space-to-depth layout, z
(B, H(+2), W, 48) bf16 -> (B, H, W, 32) bf16 (yolov8n's stem at batch 128,
640 px): pure IO, tiled IO, IO plus a pixel shift, two bf16 GEMMs with
SiLU, the GEMMs plus the shift and the union-tap concats, the whole stem.
Each rung keeps its JAX script's label and computes what its Pallas kernel
computes (ops/stem_parts.py); where a JAX ladder sweeps a TPU tile knob
(th, rows, dimension semantics), every rung is the same launch. The inputs
come from a numpy seed; z and the weights as the scripts draw them (normal,
ladder 4's weights times 0.1).

One JSON line per rung: the kernel's time (CUDA events, mean of 20 launches
after 3 of warm-up), the rate it moved its bytes at, ``bound_ms`` (the
bytes the rung must read and write over 3.35 TB/s, or its GEMM operations
over 989 TFLOP/s, the larger) and, for the copies, one ``Tensor.copy_`` of
the same slice (``library_ms``). The GEMM rungs add their compute floors
(``mufu_floor_ms``: SiLU at one MUFU operation a value; ``tensor_floor_ms``:
the products at the bf16 peak) and ``library_composite_ms``, the rung from
library calls (:func:`stem_gemm_composite`: torch ops, cuBLAS, ``F.silu``). After the ladders, the yardstick: kernel K4
(ops/stem.py:fused_stem) and cuDNN's two convolutions on the stem the
ladder is the blueprint for, (B, 3, 4H, 4W) bf16 images, C1 16, C2 32.

It runs on the card and raises without CUDA; ``--device cpu`` runs the
plain versions at a small size, timed on the host clock (``host_ms``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stem_parts as SP

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak, same source
# SiLU's floor: one MUFU operation a value (tanh.approx), 16 an SM a clock
# (CUDA C++ programming guide, compute capability 9.0), 132 SMs, 1.98 GHz
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
C1, C2 = 16, 32             # yolov8n's stem widths


class Rung(NamedTuple):
    ladder: int
    name: str        # the JAX script's label
    site: str        # file:line of the pallas_call it ports ("" for the XLA rung)
    kind: str        # "copy", "shift", "mm", or "library" (the XLA copy, no kernel)
    source: str      # the input it reads: "z", "zt20", "zt40"
    arg: object = None   # copy: (row0, cout, pixels per group, flat); shift: pixels; mm: mode


_P1 = "scripts/bench_stem_parts.py:49"
_P2, _P3, _P4 = ("scripts/bench_stem_parts2.py:47", "scripts/bench_stem_parts2.py:73",
                 "scripts/bench_stem_parts2.py:109")
_P5, _P6, _P7 = ("scripts/bench_stem_parts3.py:53", "scripts/bench_stem_parts3.py:78",
                 "scripts/bench_stem_parts3.py:103")
_P8 = "scripts/bench_stem_parts4.py:87"
# copy rungs' (row0, cout, pixels per group, flat)
_SLICE = (2, 32, 1, False)     # z[:, 2:, :, :32]
_FLAT = (2, 32, 1, True)       # the same as (n, 32) rows
_DENSE = (2, 128, 4, True)     # 4 pixels as one 192-channel row, its first 128
_HALO_IO = (0, 32, 1, False)   # ladder 4's z has no extra rows

RUNGS = [
    Rung(1, "io only (window in, slice out)", _P1, "copy", "z", _SLICE),
    Rung(1, "2 matmuls, no shifts/concat", _P1, "mm", "z", "mm"),
    Rung(1, "2 matmuls + sublane shift", _P1, "mm", "z", "mm_shift"),
    Rung(1, "2 matmuls + lane concat(48/48/12/12/8)", _P1, "mm", "z", "mm_concat"),
    Rung(1, "4-accum matmuls + shift", _P1, "mm", "z", "mm_accum"),
    Rung(2, "element io th=20", _P2, "copy", "z", _SLICE),
    Rung(2, "element io th=40", _P2, "copy", "z", _SLICE),
    Rung(2, "element io th=80", _P2, "copy", "z", _SLICE),
    Rung(2, "pre-tiled blocked io th=20", _P3, "copy", "zt20", _SLICE),
    Rung(2, "pre-tiled blocked io th=40", _P3, "copy", "zt40", _SLICE),
    Rung(2, "tiled + shift concat", _P4, "shift", "zt20", 1),
    Rung(2, "tiled + shift bitcast_roll", _P4, "shift", "zt20", 2),
    Rung(2, "tiled + shift f32_roll", _P4, "shift", "zt20", 1),
    Rung(3, "xla copy+scale (:, :32) slice", "", "library", "z", _SLICE),
    Rung(3, "pallas blocked4d th=20 parallel", _P5, "copy", "z", _SLICE),
    Rung(3, "pallas blocked4d th=20 arbitrary", _P5, "copy", "z", _SLICE),
    Rung(3, "pallas blocked4d th=40 arbitrary", _P5, "copy", "z", _SLICE),
    Rung(3, "pallas blocked2d rows=3200 arbitrary", _P6, "copy", "z", _FLAT),
    Rung(3, "pallas blocked2d rows=12800 arbitrary", _P6, "copy", "z", _FLAT),
    Rung(3, "pallas dense128 rows=3200", _P7, "copy", "z", _DENSE),
    Rung(3, "pallas dense128 rows=12800", _P7, "copy", "z", _DENSE),
] + [Rung(4, f"stem kernel [{m}]", _P8, "copy", "z", _HALO_IO) for m in ("io", "reshape_io")] \
  + [Rung(4, f"stem kernel [{m}]", _P8, "mm", "z", f"halo_{m}")
     for m in ("mm_pad", "mm_concat", "full_noshift", "full")]

KERNEL_OF = {"copy": "window_copy", "shift": "shift_add", "mm": "stem_gemm"}


def tile_windows(z: torch.Tensor, th: int) -> torch.Tensor:
    """(B, H + 2, W, C) -> (B * H/th, th + 2, W, C): the overlapping row
    windows bench_stem_parts2.py stacks outside its kernels (jnp.stack)."""
    b, hp, w, c = z.shape
    nt = (hp - 2) // th
    return torch.stack([z[:, k * th:k * th + th + 2] for k in range(nt)], 1).reshape(
        b * nt, th + 2, w, c)


def make_inputs(ladder: int, b: int, h: int, w: int, seed: int = 0,
                device="cpu") -> Dict[str, torch.Tensor]:
    """A ladder's inputs in bf16, drawn from a numpy seed with the scripts'
    shapes: z (B, H + 2, W, 48) for ladders 1-3, (B, H, W, 48) for ladder 4;
    w1 (128, 64), w2 (192, 32), w48 (48, 64), w64 (64, 32), normal (ladder
    4's times 0.1); ladder 2 adds its pre-tiled windows zt20 and zt40."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32)
        if scale != 1.0:
            a *= np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)

    scale = 0.1 if ladder == 4 else 1.0
    out = {"z": normal(b, h if ladder == 4 else h + 2, w, SP.CIN),
           "w1": normal(128, 64, scale=scale), "w2": normal(192, 32, scale=scale),
           "w48": normal(48, 64), "w64": normal(64, 32)}
    if ladder == 2:
        for th in (20, 40):
            if h % th == 0:
                out[f"zt{th}"] = tile_windows(out["z"], th)
    return out


def _copy_source(rung: Rung, x: torch.Tensor) -> torch.Tensor:
    """The tensor a copy rung's kernel reads: dense128 groups 4 pixels into
    one 192-channel row (bench_stem_parts3.py:102)."""
    group = rung.arg[2]
    if group == 1:
        return x
    b, hp, w, c = x.shape
    return x.view(b, hp, w // group, group * c)


def call(rung: Rung, inputs: Dict[str, torch.Tensor], plain: bool = False) -> torch.Tensor:
    """The rung's output through the kernel's wrapper, or its plain version
    (``plain=True``); the shape is the Pallas kernel's output shape."""
    x = inputs[rung.source]
    if rung.kind in ("copy", "library"):
        row0, cout, _, flat = rung.arg
        fn = SP.window_copy_plain if plain else SP.window_copy
        out = fn(_copy_source(rung, x), row0, cout)
        return out.reshape(-1, cout) if flat else out
    if rung.kind == "shift":
        return (SP.shift_add_plain if plain else SP.shift_add)(x, rung.arg)
    return (SP.stem_gemm_plain if plain else SP.stem_gemm)(x, inputs, rung.arg)


def library_call(rung: Rung, inputs: Dict[str, torch.Tensor]):
    """One PyTorch call computing the rung's function (``Tensor.copy_`` of
    the slice into a tensor allocated beforehand), or None."""
    if rung.kind not in ("copy", "library"):
        return None
    row0, cout, _, _ = rung.arg
    src = _copy_source(rung, inputs[rung.source])[:, row0:, :, :cout]
    dst = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    return lambda: dst.copy_(src)


LIBRARY_NONE = {
    "shift": "none: no single PyTorch call adds a tensor to its own shifted copy with "
             "column 0 masked",
    "mm": "none: no single PyTorch call computes the bf16 products with f32 sums, SiLU "
          "and the built operands",
}

# output-pixel operations of each GEMM mode (2 per multiply-add), what the
# function needs: P8's mm_pad and mm_concat output h1[:, :32] only
MODE_OPS = {"mm": 2 * (48 * 64 + 64 * 32), "mm_shift": 2 * (48 * 64 + 64 * 32),
            "mm_concat": 2 * (128 * 64 + 64 * 32), "mm_accum": 2 * (4 * 48 * 64 + 64 * 32),
            "halo_mm_pad": 2 * 48 * 32, "halo_mm_concat": 2 * 128 * 32,
            "halo_full_noshift": 2 * (128 * 64 + 192 * 32),
            "halo_full": 2 * (128 * 64 + 192 * 32)}


# SiLU values of each GEMM mode per output pixel: h1 (where a second product
# reads it) and the output
MODE_SILU = {"mm": 96, "mm_shift": 96, "mm_concat": 96, "mm_accum": 96, "halo_mm_pad": 32,
             "halo_mm_concat": 32, "halo_full_noshift": 96, "halo_full": 96}


def floors(rung: Rung, out: torch.Tensor) -> dict:
    """A GEMM rung's two compute floors beside its byte bound: SiLU at one
    MUFU operation a value, the products at the bf16 tensor-core peak."""
    b, h, w, _ = out.shape
    return dict(mufu_floor_ms=MODE_SILU[rung.arg] * b * h * w / MUFU_OPS_PER_S * 1e3,
                tensor_floor_ms=MODE_OPS[rung.arg] * b * h * w / BF16_OPS_PER_S * 1e3)


def stem_gemm_composite(z: torch.Tensor, weights: Dict[str, torch.Tensor],
                        mode: str) -> torch.Tensor:
    """A GEMM rung from library calls: the operand built with torch ops,
    cuBLAS's bf16 ``torch.matmul``, ``F.silu``, the second ``matmul``. Several
    calls, and bf16 between them where the kernel sums in f32: a yardstick
    of speed only."""
    w = weights
    mm = torch.matmul
    zp = F.pad(z, (0, 0, 0, 0, 2, 0)) if mode.startswith("halo") else z
    h = zp.shape[1] - 2
    base, prev, prev2 = zp[:, 2:2 + h], zp[:, 1:1 + h], zp[:, :h]
    if mode == "mm":
        h1 = F.silu(mm(base, w["w48"]))
    elif mode == "mm_shift":
        h1 = F.silu(mm(base + SP._shift1(base), w["w48"]))
    elif mode == "mm_concat":
        h1 = F.silu(mm(SP._union(base, prev, shift=False), w["w1"]))
    elif mode == "mm_accum":
        a = torch.cat([base, SP._shift1(base), prev2, SP._shift1(prev2)], -1)
        h1 = F.silu(mm(a, torch.cat([w["w48"]] * 4)))
    elif mode == "halo_mm_pad":
        return F.silu(mm(base, w["w1"][:SP.CIN, :SP.COUT]))
    elif mode == "halo_mm_concat":
        return F.silu(mm(SP._union(base, prev, shift=False), w["w1"][:, :SP.COUT]))
    else:
        h1all = F.silu(mm(SP._union(zp[:, 1:], zp[:, :-1], mode == "halo_full"), w["w1"]))
        cur, prv = h1all[:, 1:], h1all[:, :-1]
        return F.silu(mm(torch.cat([cur, cur, prv[..., 32:64], prv[..., 32:64]], -1), w["w2"]))
    return F.silu(mm(h1, w["w64"]))


def cost(rung: Rung, inputs: Dict[str, torch.Tensor], out: torch.Tensor):
    """(bytes, operations) the rung must move and do: the rows and channels
    of its input that the output depends on, read once, the output written
    once; the GEMM modes' products (2 per multiply-add)."""
    isz = out.element_size()
    if rung.kind in ("copy", "library"):
        return 2 * out.numel() * isz, 0.0
    if rung.kind == "shift":
        n, _, _, cout = out.shape
        # shift 2 reads one pixel of the row above each tile's first output row
        return 2 * out.numel() * isz + (n * cout * isz if rung.arg == 2 else 0), 0.0
    z = inputs[rung.source]
    b, h, w, _ = out.shape
    mode = rung.arg
    rows = h + 2 if mode == "mm_accum" else h             # z rows read in full
    extra = b * w * 12 if mode == "mm_concat" else 0      # row 1's channels 36:48
    wbytes = sum(inputs[k].numel() for k in SP.GEMM_WEIGHTS[mode]) * isz
    moved = (b * rows * w * z.shape[3] + extra) * isz + wbytes + out.numel() * isz
    return moved, float(MODE_OPS[mode]) * b * h * w


def bound(moved: float, ops: float) -> dict:
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def timer(device: torch.device):
    """Mean ms per call of a function: CUDA events on the card, the host
    clock on the CPU."""
    def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def host_ms(fn, reps: int = 20, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    return cuda_ms if device.type == "cuda" else host_ms


def run_ladder(ladder: int, inputs: Dict[str, torch.Tensor]) -> List[dict]:
    """Time every rung of ``ladder`` on ``inputs``; -> one record per rung."""
    device = inputs["z"].device
    ms_of = timer(device)
    key = "ms" if device.type == "cuda" else "host_ms"
    rows = []
    for rung in (r for r in RUNGS if r.ladder == ladder):
        lib = library_call(rung, inputs)
        rec = dict(ladder=ladder, rung=rung.name, site=rung.site or None,
                   kernel=KERNEL_OF.get(rung.kind))
        if rung.kind == "library":
            out = lib()
        else:
            out = call(rung, inputs)
            rec[key] = ms_of(lambda: call(rung, inputs))
        moved, ops = cost(rung, inputs, out)
        rec.update(bytes=moved, ops=ops)
        if device.type == "cuda":  # an H100's bound and a device rate
            rec.update(bound(moved, ops))
            if key in rec:
                rec["gb_per_s"] = moved / rec[key] / 1e6
        if lib is not None:
            rec["library_" + key] = ms_of(lib)
        else:
            rec["library"] = LIBRARY_NONE[rung.kind]
        if rung.kind == "mm":
            rec["library_composite_" + key] = ms_of(
                lambda: stem_gemm_composite(inputs["z"], inputs, rung.arg))
            if device.type == "cuda":
                rec.update(floors(rung, out))
        rows.append(rec)
    return rows


def yardstick(b: int, h: int, w: int, device: torch.device) -> dict:
    """K4 (ops/stem.py:fused_stem) and cuDNN's two convolutions (BN folded,
    + SiLU) on (B, 3, 4H, 4W) bf16 images at C1 16, C2 32: the stem whose
    ``full`` rung computes the second half on the space-to-depth layout."""
    from ..models.layers import Conv
    from ..ops import stem as S

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((b, 3, 4 * h, 4 * w), dtype=np.float32)).to(
        device=device, dtype=torch.bfloat16)
    convs = (Conv(3, C1, 3, 2), Conv(C1, C2, 3, 2))
    with torch.no_grad():
        for m in convs:
            m.to(device).eval()
            m.conv.weight.copy_(torch.from_numpy(
                rng.normal(size=tuple(m.conv.weight.shape)).astype(np.float32) * 0.3))
            m.bn.weight.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.bn.weight.shape[0]).astype(np.float32)))
        w1, bn1, w2, bn2 = S.stem_conv_params(*convs)
        (inv1, b1), (inv2, b2) = S.bn_fold(bn1), S.bn_fold(bn2)
        lw1 = (w1 * inv1[:, None, None, None]).to(torch.bfloat16)
        lw2 = (w2 * inv2[:, None, None, None]).to(torch.bfloat16)
        lb1, lb2 = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

        def cudnn():
            h1 = F.silu(F.conv2d(x, lw1, lb1, stride=2, padding=1))
            return F.silu(F.conv2d(h1, lw2, lb2, stride=2, padding=1))

        ms_of = timer(device)
        key = "ms" if device.type == "cuda" else "host_ms"
        return {"rung": "yardstick", "shape": [b, 3, 4 * h, 4 * w], "c1": C1, "c2": C2,
                "dtype": "bfloat16", f"fused_stem_{key}": ms_of(
                    lambda: S.fused_stem(x, *convs, torch.bfloat16)),
                f"cudnn_two_convs_{key}": ms_of(cudnn)}


def resolve_device(spec: str) -> torch.device:
    if spec == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec}: CUDA is not available (pass --device cpu for "
                           "the plain versions at a small size)")
    return torch.device(spec)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_stem_parts", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ladder", default="all", choices=["1", "2", "3", "4", "all"])
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--height", type=int, default=160, help="output rows H (z has H + 2)")
    p.add_argument("--width", type=int, default=160)
    return p


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ladders = [1, 2, 3, 4] if args.ladder == "all" else [int(args.ladder)]
    records = []
    with torch.no_grad():
        for ladder in ladders:
            inputs = make_inputs(ladder, args.batch, args.height, args.width, device=device)
            for rec in run_ladder(ladder, inputs):
                print(json.dumps(rec), flush=True)
                records.append(rec)
            del inputs
        rec = yardstick(args.batch, args.height, args.width, device)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
