"""The readings the limits of ``correct`` are set from, many seeds in one process.

    python -m h100_bench.readings --workload v8l-eval-cos-f32 --seeds 101-112 --seconds 3
    python -m h100_bench.readings --workload v8l-eval-cos-f32 --seeds 201-203 --control
    python -m h100_bench.readings --workload v8l-train-f32 --seeds 301-303 --fault half_batch
    python -m h100_bench.readings --workload v8l-train-f32 --seeds 301-303 --fault ema_unchanged

Each seed builds the cell anew (weights, scenes, fit) and runs a short
window of the cell's own load; ``--control`` puts the reference one
precision below the cell's in the program's place; ``--fault`` plants one
of ``faults.py`` under the program's timed path. One JSON line a seed:
the compared numbers. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import faults
from . import harness as H
from .run import run_cell


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,11")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=faults.KINDS + faults.TRAIN_KINDS)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100_bench.readings: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {H.card_line()}", file=sys.stderr, flush=True)
    for seed in seeds(args.seeds):
        t0 = time.time()
        take_out = faults.plant(args.fault) if args.fault else (lambda: None)
        try:
            line, _ = run_cell(args.workload, seed, args.seconds, False, control=args.control,
                               started=t0)
        finally:
            take_out()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault,
                          "seconds": round(time.time() - t0, 2),
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                          "checks": {k: v["value"] for k, v in line["checks"].items()}}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
