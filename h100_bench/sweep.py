"""Find the highest rate a serving cell sustains: its traffic at each of a
list of fixed rates, one process, one JSON line a rate.

    python -m h100_bench.sweep --workload v8l-serve-cos-f32 --rates 60,80,100,120 --seconds 10

A rate is sustained when nearly every request due in the window was
served in it and the latency of the last quarter of arrivals is no worse
than that of the first (no growing backlog). The cell then runs at a rate
fixed in its workload file, about four fifths of the highest sustained.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import harness as H


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100_bench.sweep: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {H.card_line()}", file=sys.stderr, flush=True)
    cell = H.load_cell(args.workload)
    driver = H.traffic_driver(cell.workload["kind"])
    for rate in (float(r) for r in args.rates.split(",")):
        out = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=False, device="cuda",
                         control=False, started=time.time(), rate=rate)
        print(json.dumps({"rate": rate, **out.end_to_end, **out.layer,
                          "attempted": out.attempted, "failed": out.failed}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
