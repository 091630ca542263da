"""The PyTorch port imports neither jax nor triton. Checked in a fresh
subprocess, because tests/conftest.py imports jax into every test process."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("modules", [
    ["ood_in_object_detection_torch.engine", "ood_in_object_detection_torch.ood.pipeline",
     "ood_in_object_detection_torch.cli.ood_eval"],
    ["ood_in_object_detection_torch.ops.nms", "ood_in_object_detection_torch.ops.roi_align",
     "ood_in_object_detection_torch.ood.distance",
     "ood_in_object_detection_torch.ops.kernels._build"],
])
def test_port_imports_no_jax_or_triton(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in ('jax', 'jaxlib', 'flax', 'triton') if n in sys.modules)\n"
            "print(','.join(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"the port imported {proc.stdout.strip()}"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port on the card and must not need JAX there,
    nor any module of the JAX package: every module its main path imports."""
    code = ("import sys, chip_smoke\n"
            "import ood_in_object_detection_torch.engine, ood_in_object_detection_torch.ood.pipeline\n"
            "import ood_in_object_detection_torch.ood.methods, ood_in_object_detection_torch.utils.weights\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'triton', 'ood_in_object_detection_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_fails_without_cuda():
    """On a machine without a card the smoke run exits non-zero and prints
    no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
