"""Serving bundles of the other YOLO families on the CPU: one name each of
yolov9, yolov10, yolo11 and yolo12 at 64 px, nc 2, seeded, BatchNorm
calibrated and head spread. ``torch.export`` specializes every Python
branch of the model (the stem gate, yolov10's one2one-only eval forward,
yolo12's area attention); the loaded bundle gives the live detector's
output bit for bit, and holds K4's operator wherever the model folds its
stem."""

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.utils import export as E
from test_torch_export import assert_outputs_equal, spread_detector
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, CONF = 64, 1e-6


@pytest.mark.parametrize("name", ["yolov9t", "yolov10n", "yolo11n", "yolo12n"])
def test_family_bundle_matches_live_detector(name, tmp_path):
    det = spread_detector(name)
    p = E.export_serving_bundle(det, None, tmp_path / name, batch=2, conf_thres=CONF)
    call, _, meta = E.load_serving_bundle(p, device="cpu")
    assert meta["neck_channels"] == det.neck_channels()
    imgs = np.random.default_rng(4).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    out = call(torch.from_numpy(imgs))
    live = det.predict(imgs, conf_thres=CONF)
    assert int(live.det.valid.sum()) > 10
    assert_outputs_equal(out, live)
    ops = [str(n.target) for n in torch.export.load(str(p / "model.pt2")).graph.nodes
           if str(n.target).startswith("ood_torch.")]
    assert det.model.stem_route == "fused"
    assert ops == ["ood_torch.fused_stem.default", "ood_torch.nms_keep.default"] + \
        ["ood_torch.roi_contract.default"] * 3
