"""Faults planted under the program's timed path, to see ``correct`` come
out false (tests/test_h100_bench_control.py, and ``readings --fault`` on the
card, whose readings bound a training cell's limits from above).

Each is a fault a one-chip cell can have; a one-chip cell has no exchange
between chips to leave out.

- ``half_batch``: half of the batch left out. Predicting, its rows get the
  other half's outputs; training, the loss is the other half's, taken as
  the mean of the whole batch.
- ``answer_altered``: an answer altered where it is produced. Predicting,
  one box's corners halved as the detect step returns them; training, the
  loss 1 % high as the step computes it.
- ``state_unchanged``: a step that returns its state unchanged. Predicting,
  every predict step after the first returns the first's outputs;
  training, the optimizer takes no step.
- ``ema_unchanged`` (training alone, ``TRAIN_KINDS``): the EMA of the
  weights left as it was, its decay read as 1.
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("half_batch", "answer_altered", "state_unchanged")
TRAIN_KINDS = ("ema_unchanged",)


def plant(kind: str):
    """Plant ``kind`` in the program; -> the function that takes it out."""
    from ood_in_object_detection_torch import engine
    from ood_in_object_detection_torch.train import trainer

    undo = []

    def patch(module, name, new):
        undo.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    if kind == "half_batch":
        predict, loss_of = engine.predict_step, trainer.loss_of

        def half_predict(model, x, *a, **kw):
            return _rows(predict(model, x[:max(x.shape[0] // 2, 1)], *a, **kw), x.shape[0])

        def half_loss(model, cfg, batch):
            b = batch["images"].shape[0]
            h = max(b // 2, 1)
            lb = loss_of(model, cfg, {k: v[:h] for k, v in batch.items()})
            return lb._replace(total=lb.total * (b / h))

        patch(engine, "predict_step", half_predict)
        patch(trainer, "loss_of", half_loss)
    elif kind == "answer_altered":
        detect, loss_of = engine.fused_detect, trainer.loss_of

        def moved(*a, **kw):
            out = detect(*a, **kw)
            boxes = out.det.boxes.clone()
            boxes[0, 0] *= 0.5
            return out._replace(det=out.det._replace(boxes=boxes))

        def high(model, cfg, batch):
            lb = loss_of(model, cfg, batch)
            return lb._replace(total=lb.total * 1.01)

        patch(engine, "fused_detect", moved)
        patch(trainer, "loss_of", high)
    elif kind == "state_unchanged":
        predict, first = engine.predict_step, []

        def stale(*a, **kw):
            if not first:
                first.append(predict(*a, **kw))
            return first[0]

        patch(engine, "predict_step", stale)
        patch(trainer, "sgd_step", lambda *a, **kw: None)
    elif kind == "ema_unchanged":
        patch(trainer, "ema_decay", lambda cfg, step: np.float32(1))
    else:
        raise ValueError(f"unknown fault {kind}; have {KINDS + TRAIN_KINDS}")

    def take_out():
        for module, name, orig in reversed(undo):
            setattr(module, name, orig)

    return take_out


def _rows(out, n):
    """Every batched field of ``out`` repeated to ``n`` rows."""
    if isinstance(out, torch.Tensor):
        reps = -(-n // out.shape[0])
        return out.repeat(reps, *([1] * (out.dim() - 1)))[:n]
    fields = [_rows(f, n) for f in out]
    return type(out)(*fields) if hasattr(out, "_fields") else tuple(fields)
