"""The traced run: torch.profiler over a bounded part of the window, spans
the benchmark puts around calls into the program, and their reduction.

- ``Tracer.span(module, attr, name, info)`` replaces a function of a
  program module by a wrapper that opens ``torch.profiler.record_function
  ("h100_bench.<name>")`` around each call and keeps ``info(args, out)``
  (shapes, and the tensors a reader needs) for the calls of the traced
  window. The wrapper exists in traced runs alone.
- ``Tracer.open()`` prepares the profiler (CPU and CUDA activities), so
  that CUPTI's start-up lies before the window; ``begin()``/``end()``
  record the traced steps alone (a few, after a few warm ones), bracketed
  by the annotation ``h100_bench.window``; ``close()``, once the measured
  window is over, reduces their chrome trace, written to ``TMPDIR`` and
  deleted. Nothing outside the traced steps is recorded, so the trace
  stays small.
- The reduction: ``window_s`` (the annotation's length), ``busy_s`` (the
  union of kernel, memcpy and memset intervals inside it), device seconds
  of the kernels each span launched (by the correlation ids of the launches
  made inside the span on its thread), the top device operations and the
  longest idle gaps by the innermost host event that covers them.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "h100_bench.window"


class Summary:
    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.spans: Dict[str, List[dict]] = collections.defaultdict(list)
        self.device_ops: List[list] = []
        self.idle_gaps: List[list] = []


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.active = False  # inside the traced window
        self._calls: Dict[str, List[dict]] = collections.defaultdict(list)
        self._patched: List[tuple] = []
        self._window = None
        self._recorded = False
        self.summary: Optional[Summary] = None

    def span(self, module, attr: str, name: str, info: Callable = None) -> None:
        if not self.enabled:
            return
        orig = getattr(module, attr)
        tag = f"h100_bench.{name}"
        calls = self._calls[name]
        tracer = self

        @functools.wraps(orig)
        def wrapped(*args, **kw):
            if not tracer.active:
                return orig(*args, **kw)
            with torch.profiler.record_function(tag):
                out = orig(*args, **kw)
            calls.append(dict(info=info(args, kw, out) if info else {}))
            return out

        setattr(module, attr, wrapped)
        self._patched.append((module, attr, orig))

    def restore(self) -> None:
        for module, attr, orig in reversed(self._patched):
            setattr(module, attr, orig)
        self._patched.clear()

    def open(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.prepare_trace()

    def begin(self) -> None:
        if not self.enabled or self.active or self._recorded:
            return
        torch.cuda.synchronize()
        self.prof.start_trace()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.active = True

    def end(self) -> None:
        if not self.enabled or not self.active:
            return
        torch.cuda.synchronize()
        self.active = False
        self._window.__exit__(None, None, None)
        self.prof.stop_trace()
        self._recorded = True

    def close(self) -> Optional[Summary]:
        if not self.enabled or self.prof is None:
            return None
        self.end()
        if not self._recorded:
            raise RuntimeError("the window ended before the traced steps began")
        fd, path = tempfile.mkstemp(suffix=".json", prefix="h100_bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = reduce(events, self._calls)
        return self.summary


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def reduce(events: List[dict], calls: Dict[str, List[dict]]) -> Summary:
    out = Summary()
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    out.window_s = (w1 - w0) * 1e-6
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    inside = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1), e)
              for e in device if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy, merged = _union([(s, t) for s, t, _ in inside])
    out.busy_s = busy * 1e-6
    by_name = collections.Counter()
    for s, t, e in inside:
        by_name[e["name"][:160]] += (t - s) * 1e-6
    out.device_ops = [[k, v] for k, v in by_name.most_common(10)]
    # idle gaps, named by the innermost host event covering their middle
    gaps = []
    prev = w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
            and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    gap_names = collections.Counter()
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = (s + t) / 2
        cover = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = min(cover, key=lambda e: float(e["dur"]))["name"][:160] if cover else "host: no event"
        gap_names[name] += (t - s) * 1e-6
    out.idle_gaps = [[k, v] for k, v in gap_names.most_common(10)]
    # spans: the device time of the kernels each call launched
    launches = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e.get("tid")].append((float(e["ts"]), e["args"]["correlation"]))
    kernel_by_corr = collections.defaultdict(float)
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            kernel_by_corr[corr] += float(e["dur"]) * 1e-6
    for name, recorded in calls.items():
        tag = f"h100_bench.{name}"
        spans = sorted((e for e in xs if e.get("name") == tag and e.get("cat") == "user_annotation"
                        and w0 <= float(e["ts"]) <= w1), key=lambda e: float(e["ts"]))
        for k, e in enumerate(spans):
            s0, s1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            corrs = [c for ts, c in launches.get(e.get("tid"), ()) if s0 <= ts <= s1]
            dev = sum(kernel_by_corr.get(c, 0.0) for c in corrs)
            n_kernels = sum(1 for c in corrs if c in kernel_by_corr)
            info = recorded[k]["info"] if k < len(recorded) else None
            out.spans[name].append(dict(device_s=dev, kernels=n_kernels, info=info))
    return out
