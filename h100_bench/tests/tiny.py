"""A copy of the benchmark's data files with one small cell of each kind
added, for the CPU tests: yolov8n and yolo12n at 64 px, run on the CPU with
the program's plain kernels."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_CONFIGS = {"tiny-v8n": ("yolov8-nc20-n", "yolov8l-nc20", "yolov8n", (0.33, 0.25, 1024)),
                "tiny-v12n": ("yolo12-nc20-n", "yolo12l-nc20", "yolo12n", (0.50, 0.25, 1024))}
SMALL = dict(batch=4, pool_batches=2, ind_batches=2, ind_batch=4, calib_images=4, warmup_steps=1,
             compare_batches=2, compare_from=2, trace_warm_steps=1, trace_steps=1)


def make_root(tmp: Path, cells=None) -> Path:
    """tmp/h100_bench with the repo's data files and the tiny cells, and
    tmp/BENCHMARK.json naming them; -> the new bench root."""
    root = tmp / "h100_bench"
    for sub in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (_, src, model, (d, w, mc)) in TINY_CONFIGS.items():
        cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
        cfg.update(name=name, program_model=model, scale="n", depth_multiple=d,
                   width_multiple=w, max_channels=mc, img_size=64)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append(dict(name=name, source=cfg["source"],
                                     file=f"h100_bench/configs/{name}.json", reduced=["nc"],
                                     why="CPU test"))
    for cell, (src, config, extra) in (cells or TINY_CELLS).items():
        wl = json.loads((BENCH / "workloads" / f"{src}.json").read_text())
        wl.update(SMALL, config=config, **extra)
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        entry = dict(name=cell, config=config, traffic=wl["traffic"] + "_tiny", chips=1, why="CPU test")
        bench["workloads"].append(entry)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if src in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


TINY_CELLS = {"tiny-eval-cos": ("v8l-eval-cos-f32", "tiny-v8n", {}),
              "tiny-eval-msp": ("v12l-eval-msp-bf16", "tiny-v12n", {}),
              "tiny-serve": ("v8l-serve-cos-f32", "tiny-v8n",
                             dict(rate=40.0, batch_size=4, pool_images=8, warmup_requests=4,
                                  compare_requests=6, drain_s=30.0)),
              "tiny-train": ("v8l-train-f32", "tiny-v8n", dict(max_gt=16, pool_batches=4))}
