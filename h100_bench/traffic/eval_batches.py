"""Eval traffic: the per-batch body of ``ood/pipeline.py:evaluate_method``,
batch after batch, over a pool of seeded scene batches.

A step is ``Detector.predict`` on a uint8 batch (its copy to the card
included), the fitted method's per-box decisions
(``ood/pipeline.py:_decisions_for_method``), and the copy of the
decisions, boxes, scores, classes and valid mask to the host, as
``evaluate_method`` makes them. The BENCHMARK_MODE cache is off, so every
step runs the forward. Workload keys: ``dtype``, ``batch``, ``pool_batches``,
``conf_thres``, ``iou_thres``, ``max_det``, ``pre_nms_k``, ``method``,
``cluster_method``, ``ind_batches``, ``ind_batch``, ``max_gt``,
``calib_images``, ``warmup_steps``, ``compare_batches``, ``compare_from``,
``trace_warm_steps``, ``trace_steps``, ``compare``, ``limits``.

``compare: chain`` holds the compared steps' outputs against the float32
reference's own forward of the same images. ``compare: layers`` follows
the program step by step from its own state: each layer of the model
against the reference layer on the program's input to it, the start (the
image to the stem's output) by itself, and the decode, NMS, taps and
decisions against the reference's on the program's own maps, fitted on the
program's own maps of the InD batches (PERF.md says why the bf16 cell
needs it).
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from h100_bench import compare, scenes, system
from h100_bench.harness import Outcome
from h100_bench.reference import precision as P
from h100_bench.reference.pipeline import Reference, capture
from h100_bench.trace import Tracer


def _stem_info(args, kw, out):
    x = args[0]
    return dict(x=tuple(x.shape), dtype=str(x.dtype).replace("torch.", ""),
                w1=tuple(args[1].conv.weight.shape), w2=tuple(args[2].conv.weight.shape),
                out=tuple(out.shape))


def _roi_info(args, kw, out):
    fmaps, boxes, anchor_idx, level_idx = args[:4]
    img_w = args[4] if len(args) > 4 else kw["img_w"]
    return dict(maps=[(tuple(f.shape), str(f.dtype).replace("torch.", "")) for f in fmaps],
                boxes=boxes, level=level_idx, anchor=anchor_idx, img_w=img_w,
                out=[(tuple(o.shape), o.element_size()) for o in out])


def run(cell, seed, seconds, trace, device, control, started) -> Outcome:
    wl, cfg = cell.workload, cell.config
    inputs, gen = system.make_inputs(cell, seed, device)
    pool = [scenes.make_scenes(gen, wl["batch"], cfg["img_size"]) for _ in range(wl["pool_batches"])]
    rng = np.random.default_rng(seed)
    compared = sorted(rng.choice(wl["compare_from"], wl["compare_batches"], replace=False).tolist())
    layerwise = wl["compare"] == "layers"
    if control:
        return _control(cell, inputs, pool, compared, layerwise)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prog = system.build_program(cell, inputs, device)
    from ood_in_object_detection_torch import engine
    from ood_in_object_detection_torch.models import yolo
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method, _np

    tracer = Tracer(trace)
    tracer.span(yolo, "fused_stem", "k4_stem", _stem_info)
    tracer.span(engine, "roi_and_exact_batched", "k2_roi", _roi_info)
    layers = prog.detector.model.model

    def body(images):
        out = prog.predict(images)
        dec = _decisions_for_method(prog.method, out, prog.neck_channels)
        host = (_np(dec), _np(out.det.boxes), _np(out.det.conf), _np(out.det.cls),
                _np(out.det.valid))
        return out, dec, host

    # warm-up; the first steps hold their outputs (and captures) as the
    # compared steps will, so that the window allocates nothing new
    held = []
    for i in range(max(wl["warmup_steps"], len(compared))):
        caps = {}
        with capture(layers, caps) if layerwise and i < len(compared) else contextlib.nullcontext():
            out, dec, _ = body(pool[i % len(pool)])
        if i < len(compared):
            held.append((out, dec, caps))
    del held
    tracer.open()
    kept, traced = {}, 0
    warm, span = wl["trace_warm_steps"], wl["trace_steps"]
    t0 = time.perf_counter()
    setup_s = time.time() - started
    step = 0
    while time.perf_counter() - t0 < seconds:
        if trace and step == warm:
            tracer.begin()
        if step in compared:
            caps = {}
            with capture(layers, caps) if layerwise else contextlib.nullcontext():
                out, dec, _ = body(pool[step % len(pool)])
            kept[step] = (out, dec, caps)
        else:
            body(pool[step % len(pool)])
        step += 1
        if trace and step == warm + span:
            tracer.end()
            traced = span
    t1 = time.perf_counter()
    if trace and tracer.active:
        tracer.end()
        traced = step - warm
    summary = tracer.close()
    tracer.restore()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    images = step * wl["batch"]
    print(f"window: {step} steps, {images} images in {t1 - t0:.4f} s; setup {setup_s:.3f} s",
          file=sys.stderr, flush=True)
    records = {}
    for s, (out, dec, caps) in kept.items():
        records[s] = system.record(out, dec)
        if layerwise:
            detect = caps.get(len(layers) - 1, (None, None))
            records[s].update(layers=caps, neck=detect[0], raw=detect[1])
    ind_maps = _program_ind_maps(prog, inputs, layers) if layerwise else None
    del kept, prog
    if on_card:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    checks = _check(cell, inputs, pool, records, ind_maps)
    print(f"check: {time.perf_counter() - t2:.3f} s", file=sys.stderr, flush=True)
    return Outcome(end_to_end={"eval_images_per_s": images / (t1 - t0), "setup_s": setup_s},
                   attempted=images, failed=0, checks=checks, memory_peak_bytes=peak,
                   layer=dict(traced_images=traced * wl["batch"], dtype=wl["dtype"]),
                   summary=summary)


@torch.no_grad()
def _program_ind_maps(prog, inputs, layers) -> list:
    """The program's raw and neck maps of the InD batches its fit saw
    (the detect layer's output and input), replayed after the window."""
    maps = []
    for images in inputs.ind:
        caps = {}
        with capture(layers[-1:], caps):
            prog.predict(images)
        if caps:  # a step that runs no model leaves nothing to fit on
            maps.append((caps[0][1], caps[0][0]))
    return maps


def _check(cell, inputs, pool, records, ind_maps=None) -> list:
    """The compared side's records against the float32 reference: from the
    reference's own forward (``compare: chain``) or, layer by layer, from
    the side's own maps and activations (``compare: layers``; ``ind_maps``:
    the side's maps of the InD batches, which the reference fits on)."""
    wl = cell.workload
    ref = inputs.reference
    if ind_maps is None:
        fitted = ref.fit([ref.predict(b) for b in inputs.ind], wl["max_gt"], wl["method"])
    else:
        fitted = ref.fit([ref.from_maps(raw, neck) for raw, neck in ind_maps], wl["max_gt"],
                         wl["method"])
    tally = compare.Tally()
    for s, rec in records.items():
        images = pool[s % len(pool)]
        if ind_maps is None:
            compare.eval_batch(tally, rec, ref, ref.predict(images), fitted)
        elif rec["raw"] is None or not ind_maps:  # no model ran: nothing can be checked
            compare.unchecked(tally, rec, 0)
        else:
            compare.eval_batch(tally, rec, ref, ref.from_maps(rec["raw"], rec["neck"]), fitted,
                               neck=False)
            compare.layers(tally, ref, rec["layers"], images)
    if not records:
        raise RuntimeError("the window ran none of the compared steps")
    return compare.judge(tally.numbers(), wl.get("limits", {}))


def _control(cell, inputs, pool, compared, layerwise) -> Outcome:
    """The reference one precision below the cell's, in the program's place."""
    wl = cell.workload
    ref = inputs.reference
    low = Reference(ref.model, cell.config, wl, mode=P.control_mode(wl["dtype"]))
    ind_preds = [low.predict(b) for b in inputs.ind]
    fitted = low.fit(ind_preds, wl["max_gt"], wl["method"])
    records = {}
    for s in compared:
        caps = {} if layerwise else None
        records[s] = low.record(low.predict(pool[s % len(pool)], caps), fitted)
        if layerwise:
            records[s]["layers"] = caps
    ind_maps = [(p.raw, p.neck) for p in ind_preds] if layerwise else None
    checks = _check(cell, inputs, pool, records, ind_maps)
    return Outcome(end_to_end={}, attempted=len(records) * wl["batch"], failed=0,
                   checks=checks, memory_peak_bytes=0)
