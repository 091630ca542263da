"""``correct`` must come out false for the control and for planted faults.

On the CPU, at a size a test run holds (the tiny cells: yolov8n and
yolo12n at 64 px, the limits of the cells they stand for): the control,
the reference one precision below the cell's (TF32 under float32, fp8
under bfloat16) in the program's place; and each fault of ``faults.py``
planted under the timed path. The ``cuda`` tests run the control and a
sound run on the card at the cells' own size.
"""

import time

import pytest
import torch

from h100_bench import faults, run
from h100_bench.tests import tiny



@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, cell, control=False):
    root = tiny.make_root(tmp_path)
    line, _ = run.run_cell(cell, 2 ** 35 + 3, 0.5, False, device="cpu", control=control,
                           root=root, benchmark=tmp_path / "BENCHMARK.json", started=time.time())
    return line


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_control_is_not_correct(tmp_path, cell):
    line = _run(tmp_path, cell, control=True)
    assert line["correct"] is False, line["checks"]


FAULTS = ([(cell, kind) for kind in faults.KINDS for cell in sorted(tiny.TINY_CELLS)]
          + [("tiny-train", kind) for kind in faults.TRAIN_KINDS])


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_planted_fault_is_not_correct(tmp_path, cell, kind):
    take_out = faults.plant(kind)
    try:
        line = _run(tmp_path, cell)
    finally:
        take_out()
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["tiny-eval-cos", "tiny-serve", "tiny-train"])
def test_sound_program_is_correct(tmp_path, cell):
    """The float32 cells' limits hold the port's plain kernels on the CPU."""
    line = _run(tmp_path, cell)
    assert line["correct"] is True, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v8l-eval-cos-f32", "v12l-eval-msp-bf16", "v8l-serve-cos-f32",
                                  "v8l-train-f32"])
def test_control_on_the_card_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, _ = run.run_cell(cell, 2 ** 35 + 5, 2.0, False, control=True, started=time.time())
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v8l-eval-cos-f32", "v12l-eval-msp-bf16", "v8l-serve-cos-f32",
                                  "v8l-train-f32"])
def test_cell_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, _ = run.run_cell(cell, 2 ** 35 + 7, 3.0, False, started=time.time())
    assert line["correct"] is True, line["checks"]
