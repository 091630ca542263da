"""Training traffic: ``train/trainer.py:train_step`` step after step on a
pool of seeded scene batches, made and placed on the card in set-up.

Each batch holds ``batch`` scenes whose discs' bounding boxes are the
ground truth, of classes drawn from the seed (scenes.make_train_batch);
no two batches share a row. Set-up builds one TrainState (the program's
model on the seed's weights, its SGD and EMA) and takes its first
``checked_steps`` steps through the same call on the pool's first batches,
then hands that state to the window, which goes on through the pool.
Each step reads its loss back to the host, as a training loop that logs
it does. Workload keys: ``dtype``, ``batch``, ``pool_batches``,
``max_gt``, ``train_config`` (the TrainConfig's fields), ``checked_steps``,
``calib_images``, ``ind_batches``, ``ind_batch``, ``trace_warm_steps``,
``trace_steps``, ``limits``.

The reference follows the checked steps from the same weights on the same
batches: each step's loss (``loss_rel_<step>``), the first step's gradient as
the optimizer took it, read from the program's momentum buffers after
that step (``grad_rel``, the worst leaf), each parameter's change over
the checked steps (``update_rel``, the worst leaf of those whose reference
gradient is over a thousandth of the median leaf's), and each parameter's
EMA's change over them (``ema_rel``, the worst leaf of the same).
"""

from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch

from h100_bench import scenes, system
from h100_bench.compare import judge
from h100_bench.harness import Outcome
from h100_bench.reference import precision as P
from h100_bench.reference import train as RT
from h100_bench.trace import Tracer

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's: moved by rounding alone under SGD


def make_pool(cell, gen) -> list:
    wl, cfg = cell.workload, cell.config
    return [scenes.make_train_batch(gen, wl["batch"], cfg["img_size"], cfg["nc"], wl["max_gt"])
            for _ in range(wl["pool_batches"])]


def run(cell, seed, seconds, trace, device, control, started) -> Outcome:
    wl, cfg = cell.workload, cell.config
    inputs, gen = system.make_inputs(cell, seed, device)
    pool = make_pool(cell, gen)
    k = wl["checked_steps"]
    if control:
        low = RT.Trainer(copy.deepcopy(inputs.reference.model), wl["train_config"],
                         mode=P.control_mode(wl["dtype"]))
        seen = _follow(low, pool[:k])
        return Outcome(end_to_end={}, attempted=k * wl["batch"], failed=0,
                       checks=_check(cell, inputs, pool, seen), memory_peak_bytes=0)

    from ood_in_object_detection_torch.models import build_model
    from ood_in_object_detection_torch.train.trainer import (TrainConfig, init_state,
                                                             trained_parameters, train_step)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg["program_model"], nc=cfg["nc"], dtype=system.DTYPES[wl["dtype"]])
    model.load_state_dict(inputs.state_dict, strict=True)
    model = model.to(device)
    tcfg = TrainConfig(**wl["train_config"])
    state = init_state(model, tcfg)
    params = dict(trained_parameters(model))
    start = {n: p.detach().clone() for n, p in params.items()}
    seen = dict(loss=[])
    for i in range(k):  # the checked steps: the window's own call and feed
        state, lb = train_step(model, tcfg, state, pool[i])
        seen["loss"].append(float(lb.total))
        if i == 0:
            bufs = state.optimizer.state
            seen["grad"] = {n: float(bufs[p]["momentum_buffer"].norm()) for n, p in params.items()
                            if p in bufs and "momentum_buffer" in bufs[p]}
    seen["update"] = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
    seen["ema"] = {n: float((state.ema[n] - start[n]).norm()) for n in params if n in state.ema}
    del start
    tracer = Tracer(trace)
    tracer.open()
    warm, span = wl["trace_warm_steps"], wl["trace_steps"]
    traced = 0
    t0 = time.perf_counter()
    setup_s = time.time() - started
    step = 0
    while time.perf_counter() - t0 < seconds:
        if trace and step == warm:
            tracer.begin()
        state, lb = train_step(model, tcfg, state, pool[(k + step) % len(pool)])
        float(lb.total)  # the loss a training loop logs
        step += 1
        if trace and step == warm + span:
            tracer.end()
            traced = span
    t1 = time.perf_counter()
    if trace and tracer.active:
        tracer.end()
        traced = step - warm
    summary = tracer.close()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    images = step * wl["batch"]
    print(f"window: {step} steps, {images} images in {t1 - t0:.4f} s; setup {setup_s:.3f} s; "
          f"checked losses {seen['loss']}", file=sys.stderr, flush=True)
    del state, model, params, lb
    if on_card:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    checks = _check(cell, inputs, pool, seen)
    print(f"check: {time.perf_counter() - t2:.3f} s", file=sys.stderr, flush=True)
    return Outcome(end_to_end={"train_images_per_s": images / (t1 - t0), "setup_s": setup_s},
                   attempted=images, failed=0, checks=checks, memory_peak_bytes=peak,
                   layer=dict(traced_images=traced * wl["batch"], dtype=wl["dtype"]),
                   summary=summary)


def _follow(trainer: RT.Trainer, batches) -> dict:
    start = {n: p.detach().clone() for n, p in trainer.params.items()}
    loss = [trainer.step(b) for b in batches]
    update = {n: float((p.detach() - start[n]).norm()) for n, p in trainer.params.items()}
    ema = {n: float((trainer.ema[n] - start[n]).norm()) for n in trainer.params}
    return dict(loss=loss, grad=trainer.first_grad, update=update, ema=ema)


def _check(cell, inputs, pool, seen: dict) -> list:
    """The checked steps against the float32 reference's, from the same
    weights on the same batches."""
    wl = cell.workload
    ref = _follow(RT.Trainer(inputs.reference.model, wl["train_config"]),
                  pool[:wl["checked_steps"]])
    numbers = {f"loss_rel_{i + 1}": abs(a - b) / max(abs(b), 1e-30)
               for i, (a, b) in enumerate(zip(seen["loss"], ref["loss"]))}
    leaves = sorted(ref["grad"])
    med = float(np.median([ref["grad"][n] for n in leaves]))
    moved = [n for n in leaves if ref["grad"][n] > NEGLIGIBLE_GRAD * med]
    numbers.update(
        grad_rel=RT.worst_leaf(_fill(seen.get("grad", {}), leaves), ref["grad"], leaves),
        update_rel=RT.worst_leaf(_fill(seen["update"], moved), ref["update"], moved),
        ema_rel=RT.worst_leaf(_fill(seen["ema"], moved), ref["ema"], moved))
    return judge(numbers, wl.get("limits", {}))


def _fill(values: dict, leaves) -> dict:
    """A leaf the program took no step on reads 0."""
    return {n: values.get(n, 0.0) for n in leaves}
