"""Card-against-CPU numerical consistency of the bf16 predict path (port of
ood_in_object_detection_tpu/utils/consistency.py).

The CPU tests hold the plain PyTorch versions against the JAX package; the
card runs the kernels (K4's bf16 route, K2's bf16 route) and cuDNN's bf16
convolutions. This check runs ONE seeded batch through the model and the
RoI/exact taps on the card and on the CPU, in one process on the same
weights, and compares every tap within bf16 tolerance. The JAX package runs
its CPU side in a subprocess only to switch JAX's platform; PyTorch takes
both devices in one process.

    python -m ood_in_object_detection_torch.utils.consistency [--model yolov8n]
"""

from __future__ import annotations

import copy
import sys

import numpy as np
import torch

# bf16 has ~3 decimal digits; conv chains accumulate to a few ulps of the
# activations' dynamic range. Tolerances are relative to each tensor's scale.
REL_TOL = 0.05


def build_model(name: str = "yolov8n", seed: int = 0):
    """A seeded bf16-compute model (f32 parameters) on the CPU, nc 8."""
    from ..models import build_model as _build, init_weights

    model = _build(name, nc=8, dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


@torch.no_grad()
def compute_outputs(model, device, img: int = 320, batch: int = 2, seed: int = 0) -> dict:
    """Deterministic pre-NMS taps of the bf16 path on ``device``: the raw
    head maps, the neck maps, and RoI/exact-position features on FIXED
    boxes and anchors (NMS keep sets are tie-degenerate on random weights
    and may differ across devices) -> {name: f32 numpy}."""
    from ..ops.roi_align import roi_and_exact_batched

    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, 3, img, img)).astype(np.float32))
    n = 32
    xy = rng.uniform(0, 1, (batch, n, 2)) * (img * 0.7)
    wh = rng.uniform(0, 1, (batch, n, 2)) * (img * 0.3) + 2.0
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    level = torch.from_numpy(rng.integers(0, 3, (batch, n)))
    m = model.to(device)
    raw_levels, neck = m(images.to(device))[:2]
    neck = [f.permute(0, 2, 3, 1).contiguous() for f in neck]
    a_total = sum(f.shape[1] * f.shape[2] for f in neck)
    aidx = (torch.arange(batch * n) * 7919 % a_total).reshape(batch, n)
    roi, exact = roi_and_exact_batched(neck, boxes.to(device), aidx.to(device),
                                       level.to(device), img_w=img)
    res = {"roi_feats": roi, "exact_feats": exact}
    res.update({f"raw{i}": f.permute(0, 2, 3, 1) for i, f in enumerate(raw_levels)})
    res.update({f"neck{i}": f for i, f in enumerate(neck)})
    return {k: v.float().cpu().numpy() for k, v in res.items()}


def compare(a: dict, b: dict, rel_tol: float = REL_TOL) -> list:
    """Returns a list of (key, rel_err) failures; empty = consistent."""
    failures = []
    for k in sorted(a):
        x, y = a[k], b[k]
        scale = max(np.abs(x).max(), np.abs(y).max(), 1e-12)
        rel = float(np.abs(x - y).max() / scale)
        print(f"  {k:12s} scale={scale:9.3g} max_rel_err={rel:.5f}")
        if rel > rel_tol:
            failures.append((k, rel))
    return failures


def check_vs_cpu(name: str = "yolov8n") -> bool:
    """The card's taps against the CPU's on the same weights; raises
    without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("consistency: needs a CUDA card (the CPU is the reference side)")
    model = build_model(name)
    here = compute_outputs(copy.deepcopy(model), "cuda")
    cpu = compute_outputs(model, "cpu")
    print(f"consistency {torch.cuda.get_device_name(0)} vs cpu ({name}):")
    failures = compare(here, cpu)
    if failures:
        print(f"FAILED: {failures}")
        return False
    print("consistency ok")
    return True


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    name = "yolov8n"
    while argv:
        a = argv.pop(0)
        if a == "--model":
            name = argv.pop(0)
    return 0 if check_vs_cpu(name) else 1


if __name__ == "__main__":
    sys.exit(main())
