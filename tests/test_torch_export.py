"""utils/export.py's program export on the CPU (the mirror of
tests/test_export_viz.py's export tests): yolov8n at 64 px, nc 2, its
BatchNorm calibrated and its head spread (utils/weights.py), so that
detections are not tie-degenerate.

The exported step runs the same ATen operators in the same order as the
live ``Detector.predict`` and the ``ood_torch`` operators' CPU
implementations, so on the CPU the loaded program's PredictOutput is held
bit for bit against the live one."""

import zipfile

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from ood_in_object_detection_torch.engine import Detector, PredictOutput
from ood_in_object_detection_torch.utils import export as E
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC, CONF = 64, 2, 1e-6


def spread_detector(name="yolov8n", nc=NC, img=IMG, seed=5, dtype=torch.float32):
    """A seeded port detector on the CPU, BatchNorm calibrated on seeded
    noise and head spread."""
    d = Detector.create(name, nc=nc, img_size=img, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    calib = np.random.default_rng(seed).uniform(0, 1, (4, 3, img, img)).astype(np.float32)
    calibrate_batchnorm(d.model, torch.from_numpy(calib))
    load_jax_variables(d.model, spread_detect_head(numpy_state_dict(d.model), seed=seed + 1))
    if dtype != torch.float32:
        d16 = Detector.create(name, nc=nc, img_size=img, device="cpu", dtype=dtype)
        d16.model.load_state_dict(d.model.state_dict())
        return d16
    return d


def assert_outputs_equal(got: PredictOutput, want: PredictOutput):
    """Every leaf of two PredictOutputs equal: shapes, dtypes and values."""
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w) == 13
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), f"leaf {i} differs by {(a.float() - b.float()).abs().max()}"


@pytest.fixture(scope="module")
def det():
    return spread_detector()


@pytest.fixture(scope="module")
def program(det, tmp_path_factory):
    return E.export_serialized(det, tmp_path_factory.mktemp("pt2") / "m.pt2", batch=2,
                               conf_thres=CONF)


def _load(path):
    E.register_output_types()
    return torch.export.load(str(path))


def test_export_serialized_roundtrip(det, program):
    """The loaded program (weights in it) gives the live predict's output,
    with detections to compare."""
    imgs = np.random.default_rng(1).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    assert program.stat().st_size > 1_000_000
    with zipfile.ZipFile(program) as z:  # the example batch is not saved
        assert sum(i.file_size for i in z.infolist() if "sample_inputs" in i.filename) == 0
    out = _load(program).module()(torch.from_numpy(imgs))
    assert isinstance(out, PredictOutput)
    live = det.predict(imgs, conf_thres=CONF)
    assert int(live.det.valid.sum()) > 10
    assert_outputs_equal(out, live)


def test_exported_program_holds_the_operators(program):
    """K4, K1 and K2 (once a level) are operator calls in the program."""
    targets = [str(n.target) for n in _load(program).graph.nodes if n.op == "call_function"]
    ops = [t for t in targets if t.startswith("ood_torch.")]
    assert ops == ["ood_torch.fused_stem.default", "ood_torch.nms_keep.default"] + \
        ["ood_torch.roi_contract.default"] * 3


def test_exported_program_moves_every_constant(program):
    """move_to_device_pass carries the weights, the captured constants and
    the device arguments of arange / zeros: on the meta device the program
    runs with no tensor left on the CPU (a mixed-device op would raise)."""
    from torch.export.passes import move_to_device_pass

    moved = move_to_device_pass(_load(program), "meta")
    out = moved.module()(torch.empty((2, IMG, IMG, 3), device="meta"))
    assert {t.device.type for t in pytree.tree_leaves(out)} == {"meta"}


def test_export_graph_text_names_the_operators(det, tmp_path):
    txt = E.export_graph_text(det, tmp_path / "graph.txt").read_text()
    for op in ("ood_torch.fused_stem", "ood_torch.nms_keep", "ood_torch.roi_contract"):
        assert op in txt
    assert "aten.convolution" in txt or "aten.conv2d" in txt


def test_export_refuses_unknown_platforms(det, tmp_path):
    with pytest.raises(ValueError, match="platforms"):
        E.export_serialized(det, tmp_path / "m.pt2", platforms=("cpu", "tpu"))


def test_load_refuses_unlisted_device(det, tmp_path):
    """A bundle exported for the card only is not served on the CPU."""
    p = E.export_serving_bundle(det, None, tmp_path / "b", platforms=("cuda",))
    with pytest.raises(ValueError, match="serves on"):
        E.load_serving_bundle(p, device="cpu")


def test_load_defaults_to_the_card(program, tmp_path, monkeypatch):
    """Without ``device`` the bundle goes to the card; with no card it
    raises rather than serve on the CPU."""
    import json
    import shutil

    shutil.copy(program, tmp_path / "model.pt2")
    (tmp_path / "bundle.json").write_text(json.dumps(dict(
        img_size=IMG, batch=2, nc=NC, conf_thres=CONF, platforms=["cpu", "cuda"],
        neck_channels=[64, 128, 256])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.load_serving_bundle(tmp_path)
    call, method, meta = E.load_serving_bundle(tmp_path, device="cpu")
    assert method is None and meta["batch"] == 2
