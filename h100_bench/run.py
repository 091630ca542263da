"""Run one cell of the port's H100 benchmark and print its result line.

    python -m h100_bench.run --workload v8l-eval-cos-f32 --seed 1 --seconds 20 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (torch.profiler over a bounded part of the window, and
the ``breakdown``). Both check the window's outputs against the plain
reference; each compared number and its limit is printed on standard
error and under ``checks``, last in the result line. The result line is
the last line of standard output. The run exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, without
the program (``ood_in_object_detection_torch``), or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness as H

_STARTED = H.process_start()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, root=H.BENCH_DIR, benchmark=None, started: float = None):
    """-> (result line dict, Outcome). ``control`` puts the reference at the
    precision below the cell's in the program's place (readings only)."""
    import torch

    cell = H.load_cell(name, root, benchmark)
    started = _STARTED if started is None else started
    driver = H.traffic_driver(cell.workload["kind"], root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outcome = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                         control=control, started=started)
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": int(cell.entry["chips"]), "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace:
        if outcome.summary is None:
            raise RuntimeError("the traced run recorded no trace")
        info["busy_s"] = outcome.summary.busy_s
        info["window_s"] = outcome.summary.window_s
        metrics = H.read_per_layer(cell, outcome, root)
    else:
        metrics = dict(outcome.end_to_end)
    missing = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)
               if m["name"] not in metrics]
    if missing and not control:
        raise RuntimeError(f"{name}: no reading for {missing}")
    return H.result_line(cell, outcome, trace, metrics, info), outcome


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        print(f"h100_bench: torch is not importable: {e}", file=sys.stderr)
        return 2
    try:
        cell = H.load_cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import ood_in_object_detection_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"h100_bench: the program is missing: {e}", file=sys.stderr)
        return 3
    print(f"card: {H.card_line()}", file=sys.stderr, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          file=sys.stderr, flush=True)
    line, outcome = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = H.forbidden_modules()
    if found:
        print(f"h100_bench: loaded in this process: {found}", file=sys.stderr)
        return 4
    print(f"card after the window: {H.card_line()}", file=sys.stderr)
    H.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
