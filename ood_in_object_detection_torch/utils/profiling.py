"""Profiling and timing (port of ood_in_object_detection_tpu/utils/profiling.py).

- ``trace(logdir)``: a ``torch.profiler`` context writing a Chrome trace
  (host and device timelines) to ``logdir``;
- ``time_fn``: milliseconds per call on the card from CUDA events after a
  warm-up, every output consumed, as the mean, min and max over calls (each
  call timed alone) and the mean of a back-to-back run (pipelined); on the
  CPU the host clock;
- ``flops_estimate``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of one call.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write
    ``trace.json`` under ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def _consume(out) -> None:
    """Touch every tensor of ``out`` so that the work that made it is done
    when the clock stops (a device sync follows)."""
    if isinstance(out, torch.Tensor):
        out.reshape(-1)[:1].sum()
    elif isinstance(out, (list, tuple)):
        for o in out:
            _consume(o)
    elif isinstance(out, dict):
        for o in out.values():
            _consume(o)


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) \
        else ()
    return any(_on_card(o) for o in items)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Dict[str, float]:
    """-> {mean_ms, min_ms, max_ms, pipelined_ms, device}: each of ``iters``
    calls timed alone (CUDA events around the call, then a synchronize),
    and ``iters`` calls back to back over their count. The first call's
    output decides where it ran; outputs on the CPU are timed by the host
    clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _consume(out)
    if out is None:
        out = fn(*args)
    cuda = _on_card(out)
    if cuda:
        torch.cuda.synchronize()

    def timed(n: int) -> float:
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                _consume(fn(*args))
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            _consume(fn(*args))
        return (time.perf_counter() - t0) * 1e3 / n

    each = [timed(1) for _ in range(iters)]
    return dict(mean_ms=sum(each) / len(each), min_ms=min(each), max_ms=max(each),
                pipelined_ms=timed(iters),
                device=torch.cuda.get_device_name(0) if cuda else "cpu")


def flops_estimate(fn: Callable, *args) -> float:
    """Floating-point operations of one call, as PyTorch's flop counter
    counts them (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
