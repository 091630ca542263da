"""What every cell shares: finding its files by name, the card's
identity, the per-layer readers, the checks and the result line.

A cell is found by its name alone: ``BENCHMARK.json`` (beside this
folder) names its configuration and the metrics it reports,
``workloads/<cell>.json`` holds its traffic's parameters and limits,
``configs/<config>.json`` its model, ``traffic/<kind>.py`` the driver of
its kind of traffic, ``metrics/<metric>.py`` one reader a per-layer
metric. Adding a cell, a configuration or a metric adds files and
entries; no code here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ood_in_object_detection_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the BENCHMARK.json workloads entry
    workload: dict     # workloads/<name>.json
    config: dict       # configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = BENCH_DIR, benchmark: Optional[Path] = None) -> Cell:
    bench = json.loads(Path(benchmark or root.parent / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    wl = json.loads((root / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((root / "configs" / f"{entry['config']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, entry, wl, cfg, e2e, per_layer)


def traffic_driver(kind: str, root: Path = BENCH_DIR):
    return _load(root / "traffic" / f"{kind}.py", f"h100_bench.traffic.{kind}")


def metric_reader(name: str, root: Path = BENCH_DIR):
    return _load(root / "metrics" / f"{name}.py", "h100_bench.metrics." + name.replace(".", "_"))


def _load(path: Path, modname: str):
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    """nvidia-smi's name, power limit and SM clock of the cards, one line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return " | ".join(out.stdout.strip().splitlines()) or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    """What a traffic driver hands back."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[dict]              # compare.judge's list
    memory_peak_bytes: int
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)  # readers' inputs
    summary: Any = None             # trace.Summary of a traced run


def read_per_layer(cell: Cell, outcome: Outcome, root: Path = BENCH_DIR) -> Dict[str, float]:
    """Every per-layer metric of the cell that its reader finds something for."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root).read(cell, outcome)
        if value is not None:
            out[m["name"]] = value
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, metrics: Dict[str, float],
                device: dict) -> dict:
    units = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    judged = [c for c in outcome.checks if c["ok"] is not None]
    correct = bool(judged) and all(c["ok"] for c in judged) and outcome.failed == 0
    line = {"correct": correct, "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if k in units},
            "device": device}
    if trace and outcome.summary is not None:
        line["breakdown"] = {"device_ops": outcome.summary.device_ops,
                             "idle_gaps": outcome.summary.idle_gaps}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in outcome.checks}
    return line


def print_checks(checks: List[dict]) -> None:
    for c in checks:
        lim = "none (reported)" if c["limit"] is None else repr(c["limit"])
        print(f"check {c['name']} {c['value']!r} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
