"""Open-loop serving traffic: single seeded scenes sent to the program's
``MicroBatchServer`` at fixed Poisson arrivals.

The server holds the live Detector and the fitted OoD method, so every
result carries per-box ``is_ood``. One generator thread submits each
request at its due time, whatever came back; each request is timed from
its due time to the moment its future resolves (stamped in the future's
done-callback, in the collector thread). The arrivals are the
exponential distribution's quantiles at ``rate`` over the window, in an
order drawn from the seed (scenes.poisson_arrivals), and each request
takes a scene of the pool drawn from the seed. Workload keys: ``dtype``,
``rate``, ``batch_size``, ``max_wait_ms``, ``pool_images``,
``conf_thres``, ``iou_thres``, ``max_det``, ``pre_nms_k``, ``method``,
``cluster_method``, ``ind_batches``, ``ind_batch``, ``max_gt``,
``calib_images``, ``warmup_requests``, ``compare_requests``,
``trace_warm_s``, ``trace_s``, ``drain_s``, ``limits``.

``serve_p95_ms`` is the 95th percentile over every request due in the
window; one that failed, or had not resolved when the window closed,
counts above every latency.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import torch

from h100_bench import compare, scenes, system
from h100_bench.harness import Outcome
from h100_bench.reference import precision as P
from h100_bench.reference.pipeline import Reference
from h100_bench.trace import Tracer


def p95(latencies: np.ndarray) -> float:
    """The 95th percentile by rank (misses are inf)."""
    srt = np.sort(latencies)
    return float(srt[max(int(math.ceil(0.95 * len(srt))) - 1, 0)])


def run(cell, seed, seconds, trace, device, control, started, rate=None) -> Outcome:
    wl, cfg = cell.workload, cell.config
    rate = wl["rate"] if rate is None else rate
    inputs, gen = system.make_inputs(cell, seed, device)
    pool = scenes.make_scenes(gen, wl["pool_images"], cfg["img_size"])
    arrivals = scenes.poisson_arrivals(rate, seconds, seed)
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(pool), len(arrivals))
    sample = sorted(rng.choice(len(arrivals), min(wl["compare_requests"], len(arrivals)),
                               replace=False).tolist())
    if control:
        return _control(cell, inputs, pool, which, sample)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prog = system.build_program(cell, inputs, device)
    from ood_in_object_detection_torch.serving import MicroBatchServer

    server = MicroBatchServer(prog.detector, batch_size=wl["batch_size"],
                              max_wait_ms=wl["max_wait_ms"], conf_thres=wl["conf_thres"],
                              pre_nms_k=wl["pre_nms_k"], ood_method=prog.method)
    steps = []
    run_step = server._run

    def counted(imgs):  # the benchmark's count of device steps
        steps.append(time.perf_counter())
        return run_step(imgs)

    server._run = counted
    server.start()
    tracer = Tracer(trace)
    try:
        for k in range(wl["warmup_requests"]):
            server.submit(pool[k % len(pool)]).result()
        n = len(arrivals)
        done = np.full(n, np.inf)
        futures = [None] * n
        late = np.zeros(n)
        tracer.open()
        t0 = time.perf_counter()
        setup_s = time.time() - started
        steps.clear()

        def stamp(i):
            def fn(fut):
                done[i] = time.perf_counter()
            return fn

        def generate():
            for i in range(n):
                due = t0 + arrivals[i]
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                late[i] = time.perf_counter() - due
                fut = server.submit(pool[which[i]])
                futures[i] = fut
                fut.add_done_callback(stamp(i))

        thread = threading.Thread(target=generate, daemon=True)
        thread.start()
        if trace:
            _sleep_until(t0 + wl["trace_warm_s"])
            tracer.begin()
            _sleep_until(t0 + wl["trace_warm_s"] + wl["trace_s"])
            tracer.end()
        _sleep_until(t0 + seconds)
        close = time.perf_counter()
        at_close = done.copy()
        n_steps = sum(1 for s in steps if s < close)
        thread.join()
        deadline = time.perf_counter() + wl["drain_s"]
        for f in futures:
            try:
                f.result(timeout=max(deadline - time.perf_counter(), 0.0))
            except Exception:  # counted below
                pass
    finally:
        server.stop()
    summary = tracer.close()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ok = np.array([f.done() and f.exception() is None for f in futures])
    served_in_window = (at_close <= close) & ok
    lat = np.where(served_in_window, (at_close - (t0 + arrivals)) * 1e3, np.inf)
    print(f"window: {n} requests at {rate} /s, {int(served_in_window.sum())} served in it, "
          f"{n_steps} steps; p50 {np.median(lat):.3f} ms, p95 {p95(lat):.3f} ms; generator late "
          f"p50 {np.median(late) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms; setup {setup_s:.3f} s",
          file=sys.stderr, flush=True)
    served = {i: futures[i].result() for i in sample if ok[i]}
    del prog, server, futures
    if on_card:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    checks = _check(cell, inputs, pool, which, served)
    print(f"check: {time.perf_counter() - t2:.3f} s", file=sys.stderr, flush=True)
    return Outcome(end_to_end={"serve_p95_ms": p95(lat), "setup_s": setup_s},
                   attempted=n, failed=int((~ok).sum()), checks=checks, memory_peak_bytes=peak,
                   layer=dict(steps=n_steps, served=int(served_in_window.sum()),
                              batch_size=wl["batch_size"], dtype=wl["dtype"],
                              p50_ms=float(np.median(lat)), late_max_ms=float(late.max() * 1e3)),
                   summary=summary)


def _sleep_until(t: float) -> None:
    while True:
        wait = t - time.perf_counter()
        if wait <= 0:
            return
        time.sleep(min(wait, 0.05))


def _check(cell, inputs, pool, which, served: dict) -> list:
    """The sampled requests' served boxes, classes, logits and verdicts
    against the float32 reference on the same scenes."""
    wl = cell.workload
    ref = inputs.reference
    fitted = ref.fit([ref.predict(b) for b in inputs.ind], wl["max_gt"], wl["method"])
    tally = compare.Tally()
    idx = sorted(served)
    for lo in range(0, len(idx), wl["batch_size"]):
        part = idx[lo:lo + wl["batch_size"]]
        pred = ref.predict(np.stack([pool[which[i]] for i in part]))
        for k, i in enumerate(part):
            compare.served_request(tally, served[i], ref, pred, k, fitted)
    if not served:
        raise RuntimeError("no sampled request was served")
    return compare.judge(tally.numbers(), wl.get("limits", {}))


def _control(cell, inputs, pool, which, sample) -> Outcome:
    """The reference one precision below the cell's serves the sampled requests."""
    wl = cell.workload
    low = Reference(inputs.reference.model, cell.config, wl, mode=P.control_mode(wl["dtype"]))
    fitted = low.fit([low.predict(b) for b in inputs.ind], wl["max_gt"], wl["method"])
    served = {}
    for lo in range(0, len(sample), wl["batch_size"]):
        part = sample[lo:lo + wl["batch_size"]]
        rec = low.record(low.predict(np.stack([pool[which[i]] for i in part])), fitted)
        for k, i in enumerate(part):
            m = rec["valid"][k]
            served[i] = dict(boxes=rec["boxes"][k][m], cls=rec["cls"][k][m],
                             logits=rec["logits"][k][m], is_ood=rec["decision"][k][m] == 0)
    checks = _check(cell, inputs, pool, which, served)
    return Outcome(end_to_end={}, attempted=len(served), failed=0, checks=checks,
                   memory_peak_bytes=0)
