"""Kernel K3 (ood/distance.py:min_group_distances) alone on the card, on
seeded inputs at the main path's shapes.

    python -m ood_in_object_detection_torch.scripts.bench_k3 [--reps 50]

N 2400 rows (batch 8 x 300 boxes), D 512 (the widest neck map), G 60 (20
classes x 3 strides), unit rows, cosine and l2:

- ``k1``: K 1, 45 of the 60 groups with a centroid (the fitted bank's shape
  under cluster method ``one``);
- ``k5``: K 5, 30 % of the centroids masked out, every 7th group empty;
- ``k200``: K 200, 30 % masked out (~20 GFLOP; K D past the 227 KB of
  shared memory a block has).

Each case prints one JSON line: the wrapper's time (``ms``, CUDA events,
host included), its device time (``device_ms``: CUDA events around the
calls queued behind a spinning kernel, so that they run back to back,
where torch.profiler may drop records), the least
time the card could take (``bound_ms``), the plain version's time and the
kernel's largest error against it, and, as an observation, cuBLAS's f32
``x @ C.T`` (TF32 off) followed by the masked minimum over K
(``cublas_amin_ms``; several calls, so no library time of the kernel). The
first line is the card's name and power limit (``nvidia-smi``). The script
uses only the package's public wrapper, so a copy of it placed in another
checkout's ``scripts/`` measures that checkout's kernel (run parent, change,
change, parent on one card to compare two versions); a case that the
checkout's kernel refuses prints its error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..ood import distance as D

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOPS = 67e12          # f32 outside the tensor cores
TOL = {"cosine": 1e-5, "l2": 1e-3}  # atol; rtol 1e-5 (tests/test_torch_distance.py)


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


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``, all its kernels (torch.profiler).
    The profiler may drop device records late in a long process (see
    :func:`profile_coverage`): :func:`queued_ms` does not depend on it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` by CUDA events, the calls
    queued behind a spinning kernel (~10 ms at first), so that they run
    back to back whatever the host's pace: the time between an event
    recorded after the spin and one after the last call, over ``reps``.
    ``fn`` must not synchronize with the host. The spin is lengthened until
    it outlasts the host's enqueueing."""
    fn()
    torch.cuda.synchronize()
    spin_cycles = 20_000_000
    for _ in range(4):
        spin0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin0.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if spin0.elapsed_time(start) > enqueue_ms:
            return start.elapsed_time(end) / reps
        spin_cycles *= 4
    raise RuntimeError(f"queued_ms: the host took {enqueue_ms:.3f} ms to enqueue {reps} calls, "
                       "longer than the spin")


def profile_coverage() -> dict:
    """How many device records a profile keeps: one elementwise kernel
    profiled with the host's events (``mul_kernels``: records of its
    kernel, 1 expected; ``kernel_after_op_us``: its record's start against
    its host op's), then 20 calls of K3 on seeded inputs (case ``k5_cosine``)
    with their records counted against the calls (``records``), their
    device ms per call by the profiler and by :func:`queued_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    x.mul(2.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x.mul(2.0)
        torch.cuda.synchronize()
    events = prof.events()
    op = [e for e in events if e.name == "aten::mul"]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    out = dict(mul_kernels=len(kernels),
               kernel_after_op_us=(kernels[0].time_range.start - op[0].time_range.start)
               if op and kernels else None)
    feats, cents, kmask, metric = k3_cases(torch.device("cuda"), metrics=("cosine",))["k5_cosine"]

    def fn():
        return D.min_group_distances(feats, cents, kmask, metric)

    reps = 20
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and "min_group" in e.name]
    out.update(calls=reps, records=len(seen),
               profiled_ms=sum(e.device_time_total for e in seen) / reps / 1e3,
               queued_ms=queued_ms(fn, reps))
    return out


def bank(rng, g: int, k: int, d: int, masked: float, empty_every: int, device, metric: str):
    """(centroids (G, K, D), kmask (G, K)): unit rows (l2: norms 0.5-1, like
    means of unit rows), ``masked`` of the centroids out, every
    ``empty_every``-th group empty."""
    c = D.l2_normalize_rows(torch.tensor(rng.normal(size=(g, k, d)), dtype=torch.float32))
    if metric != "cosine":
        c = c * torch.tensor(rng.uniform(0.5, 1.0, (g, k, 1)), dtype=torch.float32)
    m = torch.tensor(rng.uniform(size=(g, k)) >= masked)
    if empty_every:
        m[::empty_every] = False
    return c.to(device).contiguous(), m.to(device)


def k3_cases(device, metrics=("cosine", "l2"), n: int = 2400, g: int = 60, d: int = 512,
             seed: int = 3) -> dict:
    """name -> (feats (N, D), centroids (G, K, D), kmask (G, K), metric)."""
    rng = np.random.default_rng(seed)
    feats = D.l2_normalize_rows(torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32))
    feats = feats.to(device).contiguous()
    out = {}
    for metric in metrics:
        k1, m1 = bank(rng, g, 1, d, 0.0, 0, device, metric)
        m1[torch.tensor(rng.permutation(g)[: g // 4], device=device)] = False  # 45 of 60 hold one
        out[f"k1_{metric}"] = (feats, k1, m1, metric)
        out[f"k5_{metric}"] = (feats, *bank(rng, g, 5, d, 0.3, 7, device, metric), metric)
        out[f"k200_{metric}"] = (feats, *bank(rng, g, 200, d, 0.3, 0, device, metric), metric)
    return out


def cost(feats, cents, kmask, out) -> dict:
    """Bytes (inputs read once, the output written once) and flops (two a
    multiply-add over the valid centroids) -> bound_ms and what bounds it."""
    moved = sum(t.numel() * t.element_size() for t in (feats, cents, kmask, out))
    flops = 2.0 * feats.shape[0] * feats.shape[1] * float(kmask.sum())
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(bytes=moved, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def cublas_amin(feats, cents, kmask, metric):
    """-> a function: cuBLAS f32 x @ C.T over all G K centroids, then the
    distance, the mask and the minimum over K (the norms formed beforehand)."""
    n, d = feats.shape
    g, k, _ = cents.shape
    ct = cents.reshape(g * k, d).T.contiguous()
    keep = kmask.reshape(1, g * k)
    xx = (feats * feats).sum(1, keepdim=True)
    cc = (ct * ct).sum(0, keepdim=True)
    inf = torch.tensor(float("inf"), device=feats.device)

    def run():
        dots = feats @ ct
        dist = 1.0 - dots if metric == "cosine" else torch.sqrt(torch.clamp(xx + cc - 2.0 * dots,
                                                                           min=0.0))
        return torch.where(keep, dist, inf).view(n, g, k).amin(-1)

    return run


def measure(feats, cents, kmask, metric, reps: int) -> dict:
    """One case: the kernel against its plain version, and its times."""
    try:
        got = D.min_group_distances(feats, cents, kmask, metric)
        torch.cuda.synchronize()
    except RuntimeError as e:  # a checkout whose kernel refuses the case
        return dict(error=str(e).splitlines()[0])
    ref = D.min_group_distances_plain(feats, cents, kmask, metric)
    fin = torch.isfinite(ref)
    err = float((got[fin] - ref[fin]).abs().max())
    ok = bool(torch.equal(torch.isinf(got), torch.isinf(ref))) and bool(
        torch.allclose(got[fin], ref[fin], rtol=1e-5, atol=TOL[metric]))
    return dict(shape=[feats.shape[0], cents.shape[0], cents.shape[1], cents.shape[2]],
                metric=metric, valid_centroids=int(kmask.sum()),
                empty_groups=int((~kmask.any(1)).sum()), max_abs_err=err, agrees=ok,
                ms=cuda_ms(lambda: D.min_group_distances(feats, cents, kmask, metric), reps),
                device_ms=queued_ms(lambda: D.min_group_distances(feats, cents, kmask, metric),
                                    reps),
                plain_ms=cuda_ms(lambda: D.min_group_distances_plain(feats, cents, kmask, metric),
                                 max(3, reps // 5)),
                cublas_amin_ms=cuda_ms(cublas_amin(feats, cents, kmask, metric), reps),
                **cost(feats, cents, kmask, got))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k3: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "package": D.__file__}),
          flush=True)
    for label, (feats, cents, kmask, metric) in k3_cases(torch.device("cuda")).items():
        print(json.dumps(dict(kernel="min_group_distance", case=label,
                              **measure(feats, cents, kmask, metric, args.reps))), flush=True)


if __name__ == "__main__":
    main()
