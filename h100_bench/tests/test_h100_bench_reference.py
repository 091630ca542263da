"""The plain reference against the program on the CPU, at 64 px: the
same weights give the same maps, decode, NMS and taps; and the reference
imports nothing of the program."""

import ast
import json

import numpy as np
import pytest
import torch

from h100_bench import scenes
from h100_bench.reference import detect as D
from h100_bench.reference import model as M
from h100_bench.reference.pipeline import Reference
from h100_bench.tests.tiny import BENCH


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(name, img=64, seed=7):
    from ood_in_object_detection_torch.engine import Detector

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    gen = torch.Generator().manual_seed(seed)
    ref = M.build(cfg)
    calib = torch.from_numpy(scenes.make_scenes(gen, 4, img)).permute(0, 3, 1, 2).float() / 255
    M.init_from_seed(ref, gen, calib)
    det = Detector.create(cfg["program_model"], nc=cfg["nc"], img_size=img, device="cpu",
                          state_dict=M.state_dict(ref))
    return cfg, ref, det, scenes.make_scenes(gen, 2, img)


@pytest.mark.parametrize("name", ["yolov8l-nc20", "yolo12l-nc20"])
def test_reference_forward_matches_program(name):
    cfg, ref, det, imgs = _pair(name)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        raw_r, neck_r = ref(x)
        det.model.folded_stem = False
        raw_p, neck_p = det.model(x)
        det.model.folded_stem = True
        raw_f, neck_f = det.model(x)
    for r, p, f in zip(raw_r + neck_r, list(raw_p) + list(neck_p), list(raw_f) + list(neck_f)):
        scale = r.abs().max()
        assert float((r - p).abs().max() / scale) < 1e-5
        assert float((r - f).abs().max() / scale) < 1e-4  # the program's fused stem


def test_reference_predict_matches_program():
    cfg, ref_model, det, imgs = _pair("yolov8l-nc20", seed=11)
    wl = json.loads((BENCH / "workloads" / "v8l-eval-cos-f32.json").read_text())
    ref = Reference(ref_model, dict(cfg, img_size=64), wl)
    pred = ref.predict(imgs)
    out = det.predict(imgs, conf_thres=wl["conf_thres"], iou_thres=wl["iou_thres"],
                      max_det=wl["max_det"], pre_nms_k=wl["pre_nms_k"])
    for i in range(len(imgs)):
        n = int(out.det.valid[i].sum())
        anchors = out.anchor_idx[i, :n].numpy()
        mine, theirs = set(anchors.tolist()), set(pred.kept[i].tolist())
        # NMS ties at IoU 0.7 (the program offsets boxes in f32, the reference in f64)
        assert n > 10 and len(mine ^ theirs) <= 0.02 * len(mine | theirs)
        boxes, level, roi, exact = ref.box_taps(pred, i, anchors)
        assert np.abs(out.det.boxes[i, :n].numpy() - np.clip(boxes.numpy(), 0, 64)).max() < 0.05
        for k in range(n):
            c = ref.channels[int(level[k])]
            for got, want in ((out.roi_feats[i, k, :c].numpy(), roi[k]),
                              (out.exact_feats[i, k, :c].numpy(), exact[k])):
                assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def test_roi_rule_outside_the_map():
    """Inside the map both rules are torchvision's; a sample more than a
    cell outside lands on the edge under the program's rule and counts 0
    under torchvision's."""
    from ood_in_object_detection_torch.ops.roi_align import roi_align_1x1_batched_level

    f = torch.randn(8, 8, 3, generator=torch.Generator().manual_seed(0))
    inside = torch.tensor([[8.0, 8.0, 24.0, 24.0], [10.3, 5.1, 30.7, 40.2]])
    outside = torch.tensor([[-20.0, -20.0, 10.0, 10.0], [50.0, 50.0, 90.0, 90.0]])
    for boxes, same in ((inside, True), (outside, False)):
        prog = roi_align_1x1_batched_level(f[None], boxes[None], 8 / 64, samples=0)[0]
        assert torch.allclose(D.roi_align_1x1(f, boxes, 64), prog, atol=1e-6)
        tv = D.roi_align_1x1(f, boxes, 64, outside="zero")
        assert torch.allclose(tv, prog, atol=1e-6) == same


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert "ood_in_object_detection_torch" not in tops, path


def test_no_module_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "ood_in_object_detection_tpu"}
    for path in sorted(BENCH.rglob("*.py")):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & forbidden, path
        text = path.read_text()
        if path.parent.name != "tests":
            assert "bench.py" not in text and "BENCH_r" not in text and "MULTICHIP_" not in text
