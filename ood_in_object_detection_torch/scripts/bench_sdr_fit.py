"""The SDR embedder's fit (ood/sdr.py) on the card, against the same Adam
steps on the CPU from the same init on the same triplets.

    python -m ood_in_object_detection_torch.scripts.bench_sdr_fit [--steps 20]

Seeded rows of 48 features in 5 overlapping classes, ivis mode, TF32 off.
The first line is the card's name and power limit (``nvidia-smi``). Then
one JSON line per width (128-128 at 300 samples, 500-500-2000 at 700) and
variant: float32 with Adam's eps 1e-8 (the fit's own), float64, and
float32 with larger eps (EPS_VARIANTS). Each holds :func:`compare`'s
readings and, for the fit's own variant, the device ms of an Adam step
(torch.profiler). ``tests/test_torch_kernels_cuda.py`` asserts on
:func:`compare`.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess

import numpy as np
import torch

from ..ood import sdr

# the larger Adam eps of the drift readings: a step is lr * m / (sqrt(v) +
# eps), so a gradient well under eps moves its weight by far less than lr
EPS_VARIANTS = (1e-6, 1e-4)


def fit_data():
    """(700, 48) float32 rows in 5 classes that overlap (so that the losses
    stay O(1): well separated ones drive them to ~1e-19, where only their
    rounding differs), L2-normalised, and their labels."""
    rng = np.random.default_rng(2)
    y = rng.integers(0, 5, 700)
    x = (0.3 * rng.normal(size=(5, 48))[y] + rng.normal(size=(700, 48))).astype(np.float32)
    return sdr.normalized_rows(x), y


def compare(n: int, steps: int, dtype=torch.float32, eps: float = 1e-8) -> dict:
    """``steps`` Adam steps on the card and on the CPU from one seeded init
    of the width for ``n`` samples, in ``dtype`` with Adam's ``eps`` ->
    each step's loss on the card relative to the CPU's; each parameter
    array's move on the card against the CPU's (the Frobenius norm of the
    difference over that of the CPU's move); the last bias's largest gap
    (its gradient is rounding noise: the bias cancels in the loss); the
    card fit's steps, seconds and host-sampling seconds a step; and of the
    first step (Adam's step 1 is lr * g / (|g| + eps)): the elements that
    moved in opposite directions on the two devices, outside the last bias,
    their share of the moves' squared difference there, and their largest
    CPU gradient beside the median one."""
    flat, y = fit_data()
    init = sdr.TripletEmbedder(sdr.embedder_widths(n, 48, 32), seed=4).to(dtype)

    def run(dev, k):
        m = copy.deepcopy(init).to(dev)
        return m, sdr.train_triplet_embedder(m, flat, y, max_steps=k, eps=eps).cpu()

    (c1, _), (g1, _) = run("cpu", 1), run("cuda", 1)
    flips = gap = flip_gap = 0.0
    flip_grad, grads = [], []
    for a, b, p in list(zip(g1.parameters(), c1.parameters(), init.parameters()))[:-1]:
        da, db = a.detach().cpu() - p.detach(), b.detach() - p.detach()
        flip = torch.sign(da) != torch.sign(db)
        flips += float(flip.sum())
        gap += float(((da - db) ** 2).sum())
        flip_gap += float(((da - db)[flip] ** 2).sum())
        flip_grad.append(b.grad[flip].abs())
        grads.append(b.grad.abs().reshape(-1))
    flip_grad, grads = torch.cat(flip_grad), torch.cat(grads)

    cpu, l_cpu = run("cpu", steps)
    card, l_card = run("cuda", steps)
    params = list(zip(card.parameters(), cpu.parameters(), init.parameters()))
    stats = card.fit_stats
    return dict(
        widths=init.widths, dtype=str(dtype).replace("torch.", ""), eps=eps,
        steps=stats["steps"],
        seconds_per_step=stats["seconds"] / steps,
        sampling_s_per_step=stats["sampling_s"] / steps,
        loss_rel_diff=((l_card - l_cpu).abs() / l_cpu.abs()).tolist(),
        move_rel_diff=[float((a.detach().cpu() - b.detach()).norm()
                             / (b.detach() - p.detach()).norm()) for a, b, p in params],
        last_bias_max_abs=float((params[-1][0].detach().cpu() - params[-1][1].detach())
                                .abs().max()),
        first_step=dict(elements=int(grads.numel()), opposite=int(flips),
                        opposite_share_of_gap=flip_gap / gap if gap else 0.0,
                        opposite_max_abs_grad=float(flip_grad.max()) if flip_grad.numel()
                        else 0.0,
                        median_abs_grad=float(grads.median())))


def main(argv=None) -> None:
    from .bench_k3 import device_ms

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_sdr_fit: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    flat, y = fit_data()
    for n in (300, 700):
        r = compare(n, args.steps)
        probe = sdr.TripletEmbedder(r["widths"]).to("cuda")
        r["device_ms_per_step"] = device_ms(
            lambda: sdr.train_triplet_embedder(probe, flat, y, max_steps=args.steps),
            1) / args.steps
        print(json.dumps(r), flush=True)
        print(json.dumps(compare(n, args.steps, dtype=torch.float64)), flush=True)
        for eps in EPS_VARIANTS:
            print(json.dumps(compare(n, args.steps, eps=eps)), flush=True)


if __name__ == "__main__":
    main()
