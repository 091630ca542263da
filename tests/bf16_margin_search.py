"""How far bf16 rounding moves a random YOLOv8n's outputs, against the
margins a test fixture can offer (the fixture of tests/test_torch_bf16.py).

    JAX_PLATFORMS=cpu python tests/bf16_margin_search.py --seeds 0 120
    JAX_PLATFORMS=cpu python tests/bf16_margin_search.py --seeds 0 3 --bn-scale 1.0

For each seed: 16 seeded uint8 images at 96 px (8 InD, 8 OoD), yolov8n with
nc=2 and the weights tests/test_torch_model.py:shared_weights builds (every
BatchNorm scale set to --bn-scale before the calibration, the head spread
by --spread), run by the port in f32 and in bf16 on the CPU. Printed per
seed: the spread of the maps (largest |bf16 - f32| over the largest |f32|,
raw head maps and neck maps), the spread of the confidences on the OoD
images, and over confidence thresholds placed in the widest gaps that keep
2-8 candidates per image, the best ratio of the fixture's smallest margin
(a confidence to its threshold, or two overlapping candidates to each
other) to that spread. A ratio above 1 would allow exact comparisons with
margins above the bf16 spread. The last line is the best seed.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

from test_torch_model import shared_weights  # noqa: E402

from ood_in_object_detection_torch.models import build_model  # noqa: E402
from ood_in_object_detection_torch.ops import nms as tnms  # noqa: E402
from ood_in_object_detection_torch.ops.boxes import box_iou  # noqa: E402
from ood_in_object_detection_torch.ops.fused_detect import select_candidates  # noqa: E402

IMG, NC, N_IMAGES, IOU = 96, 2, 16, 0.7


def confidences(raw):
    return torch.sigmoid(torch.cat([r[:, 64:].float().amax(1).flatten(1) for r in raw], 1))


def best_ratio(raw, conf, spread):
    """The best margin / spread over thresholds in the widest gaps."""
    v = np.sort(conf.flatten().numpy())[::-1]
    best = 0.0
    for per_image in range(2, 9):
        k = per_image * len(conf)
        thr = float((v[k] + v[k + 1]) / 2)
        cand = select_candidates(raw, NC, thr, pre_nms_k=1024)
        margin = float((conf - thr).abs().min())
        for i in range(len(conf)):
            boxes, valid = tnms.nms_inputs(cand.boxes[i], cand.conf[i], cand.cls[i], thr)
            if valid.sum() < 2:
                continue
            iou = box_iou(boxes[valid], boxes[valid])
            c = cand.conf[i][valid]
            near = (iou > IOU - 0.2) & ~torch.eye(len(c), dtype=torch.bool)
            if near.any():
                margin = min(margin, float((c[:, None] - c[None, :]).abs()[near].min()))
        best = max(best, margin / spread)
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 20), metavar=("FIRST", "END"))
    ap.add_argument("--bn-scale", type=float, default=0.2)
    ap.add_argument("--spread", type=float, default=2.0)
    args = ap.parse_args()
    results = []
    for seed in range(*args.seeds):
        images = np.random.default_rng(seed).integers(0, 256, (N_IMAGES, IMG, IMG, 3),
                                                      dtype=np.uint8)
        x = torch.from_numpy(images).float().permute(0, 3, 1, 2) / 255
        _, _, f32 = shared_weights("yolov8n", nc=NC, seed=seed, calib=x, spread=args.spread,
                                   bn_scale=args.bn_scale)
        bf16 = build_model("yolov8n", nc=NC, dtype=torch.bfloat16)
        bf16.load_state_dict(f32.state_dict())
        with torch.no_grad():
            raw, neck = f32(x)
            raw16, neck16 = bf16.eval()(x)
        maps = max(float((b.float() - a).abs().max() / a.abs().max())
                   for a, b in zip(raw + neck, raw16 + neck16))
        ood = slice(N_IMAGES // 2, None)
        conf, conf16 = confidences([r[ood] for r in raw]), confidences([r[ood] for r in raw16])
        spread = float((conf - conf16).abs().max())
        ratio = best_ratio([r[ood] for r in raw], conf, spread)
        results.append((ratio, seed))
        print(f"seed {seed}: map spread {maps:.3g}, OoD confidence spread {spread:.3g}, "
              f"best margin / spread {ratio:.3g}", flush=True)
    ratio, seed = max(results)
    print(f"best: seed {seed}, margin / spread {ratio:.3g}")


if __name__ == "__main__":
    main()
