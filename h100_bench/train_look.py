"""Where a training cell's steps part from the reference: each step's
task-aligned assignment, the program's against the reference's, and the
reference's against itself in another float32 order (cuDNN's benchmark
mode, which picks other convolution algorithms).

    python -m h100_bench.train_look --workload v8l-train-f32 --seeds 121-124 --steps 3

One JSON line a seed and step: the foreground anchors of each side, the
anchors in one foreground and not the other (``fg_differ``), those in both
whose target box differs (``target_differ``), and the loss's relative gap.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import torch

from . import harness as H
from . import system
from .readings import seeds
from .reference import train as RT


def _recording(module, name, log, pick):
    """Wrap ``module.name`` so that each call appends ``pick(result)`` to
    ``log``; -> the function that unwraps it."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        log.append(pick(out))
        return out

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, orig)


def program_steps(cell, inputs, pool, steps, device) -> tuple:
    from ood_in_object_detection_torch.models import build_model
    from ood_in_object_detection_torch.train import loss as L
    from ood_in_object_detection_torch.train.trainer import TrainConfig, init_state, train_step

    wl, cfg = cell.workload, cell.config
    model = build_model(cfg["program_model"], nc=cfg["nc"], dtype=system.DTYPES[wl["dtype"]])
    model.load_state_dict(inputs.state_dict, strict=True)
    model = model.to(device)
    tcfg = TrainConfig(**wl["train_config"])
    state = init_state(model, tcfg)
    log, losses = [], []
    undo = _recording(L, "assign", log,
                      lambda r: (r.fg_mask.bool().clone(), r.target_bboxes.float().clone()))
    try:
        for i in range(steps):
            state, lb = train_step(model, tcfg, state, pool[i])
            losses.append(float(lb.total))
    finally:
        undo()
    return losses, log


def reference_steps(cell, model, pool, steps, benchmark: bool) -> tuple:
    log = []
    undo = _recording(RT, "assign", log, lambda r: (r[2].clone(), r[0].float().clone()))
    torch.backends.cudnn.benchmark = benchmark
    try:
        trainer = RT.Trainer(model, cell.workload["train_config"])
        losses = [trainer.step(b) for b in pool[:steps]]
    finally:
        torch.backends.cudnn.benchmark = False
        undo()
    return losses, log


def parted(a, b) -> dict:
    (fa, ta), (fb, tb) = a, b
    both = fa & fb
    return dict(fg=int(fa.sum()), fg_other=int(fb.sum()), fg_differ=int((fa ^ fb).sum()),
                target_differ=int(((ta - tb).abs().amax(-1) > 1e-3)[both].sum()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100_bench.train_look: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = H.load_cell(args.workload)
    driver = H.traffic_driver(cell.workload["kind"])
    print(f"card: {H.card_line()}", file=sys.stderr, flush=True)
    for seed in seeds(args.seeds):
        inputs, gen = system.make_inputs(cell, seed, "cuda")
        pool = driver.make_pool(cell, gen)
        start = copy.deepcopy(inputs.reference.model)
        prog = program_steps(cell, inputs, pool, args.steps, "cuda")
        torch.cuda.empty_cache()
        ref = reference_steps(cell, inputs.reference.model, pool, args.steps, False)
        other = reference_steps(cell, start, pool, args.steps, True)
        for i in range(args.steps):
            print(json.dumps({
                "seed": seed, "step": i + 1,
                "program_vs_reference": dict(
                    loss_rel=abs(prog[0][i] - ref[0][i]) / abs(ref[0][i]),
                    **parted(prog[1][i], ref[1][i])),
                "reference_reordered": dict(
                    loss_rel=abs(other[0][i] - ref[0][i]) / abs(ref[0][i]),
                    **parted(other[1][i], ref[1][i]))}), flush=True)
        del inputs, pool, start, prog, ref, other
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
