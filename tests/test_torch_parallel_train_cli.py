"""``cli.train --device cpu,cpu`` on the CPU: two gloo ranks (one process
each, joined within the CLI), the global batch of the single-process run
split between them. tests/test_torch_train_cli.py's fixture (yolov8n at 64
px, nc 2, 8 scenes, batch 4, augmentation on, 1 epoch of 2 steps).

Rank 0 alone writes results.csv, the tensorboard events and the
checkpoint, in the single-process format; the epoch's loss terms equal the
single-process run's (the same batches in the same order, the global step:
within 1e-4 relative, the second step starting from states ~1e-6 apart);
``--resume`` takes a checkpoint written by the ranks in either mode and
continues at the next epoch."""

import json

import numpy as np
import pytest
import torch
from test_torch_train_cli import CSV_HEADER, fixture_data, train_args  # noqa: F401 (fixture)
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.cli import train as ttrain

DP = ("--device", "cpu,cpu")


@pytest.fixture(scope="module")
def runs(fixture_data):  # noqa: F811
    """One epoch on one process and on two ranks."""
    root, yaml, _, _ = fixture_data
    ttrain.main(train_args(root, yaml, "--epochs", "1", "--name", "single"))
    ttrain.main(train_args(root, yaml, "--epochs", "1", "--name", "dp", *DP))
    return root / "runs" / "single", root / "runs" / "dp"


def _losses(run_dir):
    lines = (run_dir / "results.csv").read_text().splitlines(keepends=True)
    assert lines[0] == CSV_HEADER
    return [np.asarray(ln.strip().split(",")[2:6], np.float64) for ln in lines[1:]]


def test_two_ranks_write_one_results_csv_and_checkpoint(runs):
    single, dp = runs
    assert len(list(dp.glob("events.out.tfevents.*"))) == 1
    (got,), (want,) = _losses(dp), _losses(single)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    meta = json.loads((dp / "meta.json").read_text())
    assert meta["epoch"] == 0 and meta["train_args"]["device"] == "cpu,cpu"
    payload = torch.load(dp / "state.pt", weights_only=True)
    ref = torch.load(single / "state.pt", weights_only=True)
    assert payload["step"] == 2 and payload["opt_state"]["state"]
    assert set(payload) == set(ref) and set(payload["params"]) == set(ref["params"])
    row = (dp / "results.csv").read_text().splitlines()[1].split(",")
    assert np.isfinite(float(row[-2])), "rank 0 validated"


@pytest.mark.parametrize("resume_dp", [True, False])
def test_resume_from_a_data_parallel_checkpoint(fixture_data, runs, resume_dp):  # noqa: F811
    """The two ranks' epoch-0 checkpoint resumed on two ranks and on one
    process: epoch 1 follows, 4 steps in all."""
    root, yaml, _, _ = fixture_data
    name = f"resume_{'dp' if resume_dp else 'single'}"
    run = root / "runs" / name
    run.mkdir(parents=True)
    for f in runs[1].iterdir():
        (run / f.name).write_bytes(f.read_bytes())
    ttrain.main(train_args(root, yaml, "--epochs", "2", "--name", name, "--resume", str(run),
                           *(DP if resume_dp else ())))
    lines = (run / "results.csv").read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["0", "1"]
    assert json.loads((run / "meta.json").read_text())["epoch"] == 1
    assert torch.load(run / "state.pt", weights_only=True)["step"] == 4


def test_a_batch_that_does_not_divide_over_the_ranks_raises(fixture_data):  # noqa: F811
    root, yaml, _, _ = fixture_data
    with pytest.raises(ValueError, match="divide"):
        ttrain.main(train_args(root, yaml, "--name", "odd", "--device", "cpu,cpu,cpu"))
