"""A ``--bf16`` detector's serving bundle on the CPU: yolov8n at 64 px,
nc 2, f32 parameters and bf16 compute and taps. The exported step runs the
live step's operators in the same order (the ``ood_torch`` operators'
bf16 routes: K4's bf16 stem, K2b's bf16 maps), so the loaded bundle gives
the live bf16 detector's output bit for bit, the neck maps and taps in
bf16."""

import numpy as np
import torch

from ood_in_object_detection_torch.utils import export as E
from test_torch_export import assert_outputs_equal, spread_detector
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, CONF = 64, 1e-6


def test_bf16_bundle_matches_live_bf16_detector(tmp_path):
    det = spread_detector(dtype=torch.bfloat16)
    p = E.export_serving_bundle(det, None, tmp_path / "b16", batch=2, conf_thres=CONF)
    call, method, meta = E.load_serving_bundle(p, device="cpu")
    assert method is None and meta["batch"] == 2
    imgs = np.random.default_rng(2).integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs).float() * torch.tensor(1.0 / 255.0)
    out = call(x)
    live = det.predict(imgs, conf_thres=CONF)
    assert out.neck[0].dtype == torch.bfloat16 and out.roi_feats.dtype == torch.bfloat16
    assert int(live.det.valid.sum()) > 10
    assert_outputs_equal(out, live)
    ops = [str(n.target) for n in torch.export.load(str(p / "model.pt2")).graph.nodes
           if str(n.target).startswith("ood_torch.")]
    assert ops[0] == "ood_torch.fused_stem.default"
