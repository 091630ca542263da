"""The harness on the CPU: cells found by name alone, the result line's
keys, BENCHMARK.json against the contract's shape."""

import json
import re
import shutil
import time

import pytest
import torch

from h100_bench import harness as H
from h100_bench import run
from h100_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(tmp_path, cell, **kw):
    root = tiny.make_root(tmp_path)
    kw.setdefault("seconds", 0.5)
    return run.run_cell(cell, kw.pop("seed", 2 ** 33 + 17), kw.pop("seconds"), kw.pop("trace", False),
                        device="cpu", root=root, benchmark=tmp_path / "BENCHMARK.json",
                        started=time.time(), **kw)


def test_a_dropped_workload_file_is_found(tmp_path):
    """A new cell is a workload file and a BENCHMARK.json entry: no code."""
    root = tiny.make_root(tmp_path)
    src = json.loads((root / "workloads" / "tiny-eval-cos.json").read_text())
    src.update(batch=2, conf_thres=0.2)
    (root / "workloads" / "tiny-eval-cos-b2.json").write_text(json.dumps(src))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny-eval-cos-b2", config="tiny-v8n",
                                   traffic="eval_cos_f32_b2", chips=1, why="CPU test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-eval-cos" in m.get("workloads", ()):
            m["workloads"].append("tiny-eval-cos-b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = H.load_cell("tiny-eval-cos-b2", root, tmp_path / "BENCHMARK.json")
    assert cell.workload["batch"] == 2
    assert {m["name"] for m in cell.end_to_end} == {"eval_images_per_s", "setup_s"}
    line, _ = run.run_cell("tiny-eval-cos-b2", 5, 0.5, False, device="cpu", root=root,
                           benchmark=tmp_path / "BENCHMARK.json", started=time.time())
    assert line["attempted"] % 2 == 0 and line["metrics"]["eval_images_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_result_line_keys(tmp_path, cell):
    line, outcome = run_tiny(tmp_path, cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert NAME.match(name) and isinstance(c["value"], float)
    json.dumps(line)


def test_benchmark_json_shape():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100_bench"] and 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (tiny.BENCH / "workloads" / f"{w['name']}.json").exists()
        cell = H.load_cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in bench["configs"]:
        cfg = json.loads((tiny.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "v8l-eval-cos-f32", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path, monkeypatch, capsys):
    """A checkout of BENCHMARK.json and h100_bench/ alone has no program."""
    shutil.copytree(tiny.BENCH, tmp_path / "h100_bench")
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "v8l-eval-cos-f32",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
