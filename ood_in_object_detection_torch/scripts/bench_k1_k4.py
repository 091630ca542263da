"""Kernels K1 (the NMS keep mask) and K4 (the fused stem) alone on the card,
on seeded inputs at the main path's shapes.

    python -m ood_in_object_detection_torch.scripts.bench_k1_k4 [--reps 50]

K1 (ops/nms.py:greedy_keep) on (8, 1024) clustered boxes (as chip_smoke's
``controlled`` case), on a ``chain`` where each box overlaps the next and
greedy NMS keeps every second one, on (1, 4096) and (1, 16384) all-valid
boxes and on (2, 8400) boxes, 90 % valid: the wrapper's time (CUDA events)
and the device time of each of its two kernels, the mask phase and the
sweep phase (torch.profiler), with the keep mask held equal to the plain
version. K4 (ops/stem.py:fused_stem_launch on
operands folded once) at yolov8l's stem widths (C1 64, C2 128) on (8, 3,
640, 640) images, f32 and bf16, beside cuDNN's two convolutions (TF32 off)
and its error against the plain version.

One JSON line per case; the first line is the card's name and power limit
(``nvidia-smi``). The script uses only the package's public wrappers, so a
copy of it placed in another checkout's ``scripts/`` measures that
checkout's kernels (run parent, change, change, parent on one card to
compare two versions).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nms as N
from ..ops import stem as S


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
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


def device_ms_by_kernel(fn, reps: int) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def k1_phase_ms(boxes, valid, reps: int) -> dict:
    """{"mask": ms, "sweep": ms} of greedy_keep's two kernels."""
    rows = device_ms_by_kernel(lambda: N.greedy_keep(boxes, valid, 0.7), reps)
    out = {}
    for phase in ("mask", "sweep"):
        hits = [v for k, v in rows.items() if f"nms_{phase}" in k]
        out[phase] = sum(hits) if hits else "not measured"
    return out


def k1_cases() -> dict:
    """K1's seeded cases, name -> ((B, k, 4) boxes in score order, (B, k)
    validity): clustered boxes at (8, 1024), 90 % valid; the chain; 4096
    valid boxes spread over 3 classes; 8400 (640 px's anchor count) in two
    images, 90 % valid; 16384 valid, past the 14,272 where staging whole
    64-row blocks of the mask in shared memory stops fitting."""
    rng = np.random.default_rng(2)
    centres = rng.uniform(20, 600, (8, 257, 2))
    pick = rng.integers(0, 257, (8, 1024))
    c = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 4, (8, 1024, 2))
    wh = rng.uniform(20, 120, (8, 1024, 2))
    controlled = (np.concatenate([c - wh / 2, c + wh / 2], -1), rng.uniform(size=(8, 1024)) > 0.1)
    return {"controlled": controlled, "chain": chain_boxes(8, 1024),
            "k4096": (random_boxes(rng, 1, 4096), np.ones((1, 4096), bool)),
            "k8400": (random_boxes(rng, 2, 8400), rng.uniform(size=(2, 8400)) > 0.1),
            "k16384": (random_boxes(rng, 1, 16384), np.ones((1, 16384), bool))}


def chain_boxes(b: int, k: int):
    """(B, k) chains: boxes i and i + 1 overlap with IoU 0.8, boxes i and
    i + 2 with IoU 0.64, so greedy NMS at 0.7 keeps every second box (a
    one-pass suppression would keep only the first); all valid."""
    x0 = np.arange(k, dtype=np.float64)[None, :].repeat(b, 0) * (10.0 / 9.0)
    boxes = np.stack([x0, np.zeros_like(x0), x0 + 10.0, np.full_like(x0, 10.0)], -1)
    boxes[..., 1::2] += np.arange(b)[:, None, None] * 50.0   # images differ
    return boxes, np.ones((b, k), bool)


def random_boxes(rng, b: int, k: int):
    c = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(5, 200, (b, k, 2))
    cls = rng.integers(0, 3, (b, k))
    return np.concatenate([c - wh / 2, c + wh / 2], -1) + (cls * N.MAX_WH)[..., None]


def stem_params(rng, c1: int, c2: int, device):
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def bn(c):
        return dict(scale=t(rng.uniform(0.5, 1.5, c)), bias=t(rng.normal(size=c) * 0.1),
                    mean=t(rng.normal(size=c) * 0.1), var=t(rng.uniform(0.5, 2.0, c)))

    return (t(rng.normal(size=(c1, 3, 3, 3)) * 0.5), bn(c1),
            t(rng.normal(size=(c2, c1, 3, 3)) * 0.2), bn(c2))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1_k4: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "package": S.__file__}),
          flush=True)

    for label, (boxes, valid) in k1_cases().items():
        b = torch.tensor(boxes, dtype=torch.float32, device=dev)
        v = torch.tensor(valid, device=dev)
        got, ref = N.greedy_keep(b, v, 0.7), N.greedy_keep_plain(b, v, 0.7)
        print(json.dumps(dict(kernel="nms_keep", case=label, shape=list(b.shape),
                              kept=int(got.sum()), mismatches=int((got != ref).sum()),
                              ms=cuda_ms(lambda: N.greedy_keep(b, v, 0.7), args.reps),
                              phase_ms=k1_phase_ms(b, v, args.reps))), flush=True)

    rng = np.random.default_rng(4)
    w1, bn1, w2, bn2 = stem_params(rng, 64, 128, dev)
    x = torch.tensor(rng.uniform(0, 1, (8, 3, 640, 640)), dtype=torch.float32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        xi = x.to(dt)
        ops = S.k4_operands(w1, bn1, w2, bn2, dt)
        got = S.fused_stem_launch(xi, ops, 64, 128, dt).float()
        ref = S.fused_stem_plain(xi, w1, bn1, w2, bn2, dt).float()
        inv1, b1 = S.bn_fold(bn1)
        inv2, b2 = S.bn_fold(bn2)
        lw1, lw2 = ((w * inv[:, None, None, None]).to(dt) for w, inv in ((w1, inv1), (w2, inv2)))
        lb1, lb2 = b1.to(dt), b2.to(dt)

        def library():
            h1 = F.silu(F.conv2d(xi, lw1, lb1, stride=2, padding=1))
            return F.silu(F.conv2d(h1, lw2, lb2, stride=2, padding=1))

        print(json.dumps(dict(kernel="fused_stem", dtype=str(dt).split(".")[-1],
                              shape=list(x.shape), c1=64, c2=128,
                              rel_err=float((got - ref).abs().max() / ref.abs().max()),
                              kernel_ms=cuda_ms(lambda: S.fused_stem_launch(xi, ops, 64, 128, dt),
                                                args.reps),
                              library_ms=cuda_ms(library, args.reps))), flush=True)


if __name__ == "__main__":
    main()
