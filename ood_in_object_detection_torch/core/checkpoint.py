"""Checkpoints with the reference's cache-key contract (port of
ood_in_object_detection_tpu/core/checkpoint.py).

The reference stores torch ``.pt`` checkpoints whose ``train_args['name']``
keys the OoD cache paths (ood_evaluation.py:296-300). Here, as in the JAX
package, a checkpoint is a directory:

- ``state.pt`` (``torch.save``): ``{"params": state_dict, "ema_params":
  state_dict, "nc": int}``, each state_dict ultralytics-named (the names
  ``utils/weight_import.py:export_state_dict`` of the JAX package writes and
  the port's modules carry), f32 where floating, on the CPU; a training
  state (train/trainer.py:TrainState) adds ``opt_state`` (the optimizer's
  state_dict: its momentum buffers) and ``step``, as the JAX package's
  checkpoint does, for :func:`restore_train_state`;
- ``meta.json``: ``train_args`` (with ``name``), ``model_name`` and
  ``epoch``, the JAX package's keys.

A JAX checkpoint converts by the JAX package's ``load_checkpoint`` ->
``export_state_dict`` -> :func:`save_checkpoint` (README.md), where JAX is
installed: the port itself never imports it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.weights import class_count


def _cpu_tree(obj):
    """An optimizer state_dict's tensors copied to the CPU, the rest as is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_tree(v) for v in obj)
    return obj


def _cpu_state_dict(weights) -> Dict[str, torch.Tensor]:
    """An nn.Module's or a mapping's tensors (torch or numpy) on the CPU,
    floating ones in f32, each its own copy."""
    sd = weights.state_dict() if isinstance(weights, nn.Module) else weights
    out = {}
    for k, v in sd.items():
        t = torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v.detach()
        t = t.to("cpu", copy=True)
        out[k] = t.float() if t.is_floating_point() else t
    return out


def save_checkpoint(path: str, state, train_args: Dict[str, Any], model_name: str,
                    epoch: int = 0) -> None:
    """Write the checkpoint directory ``path``. ``state`` is an ``nn.Module``
    (its weights are both the parameters and the EMA), a training state
    (train/trainer.py:TrainState: its parameters, EMA, optimizer state and
    step), or a mapping with ``params`` and optionally ``ema_params``
    (default: ``params``), each a module or a state_dict of torch tensors or
    numpy arrays. The class count comes from the detect head's class bias
    (``cv3.0.2.bias``)."""
    extra = {}
    if isinstance(state, nn.Module):
        params = ema = _cpu_state_dict(state)
    elif isinstance(state, Mapping):
        params = _cpu_state_dict(state["params"])
        ema = _cpu_state_dict(state["ema_params"]) if state.get("ema_params") is not None \
            else params
    else:  # a TrainState
        params, ema = _cpu_state_dict(state.params), _cpu_state_dict(state.ema_params)
        extra = {"opt_state": _cpu_tree(state.optimizer.state_dict()), "step": int(state.step)}
    p = Path(path).resolve()
    p.mkdir(parents=True, exist_ok=True)
    torch.save({"params": params, "ema_params": ema, "nc": class_count(params), **extra},
               p / "state.pt")
    (p / "meta.json").write_text(json.dumps({
        "train_args": train_args,
        "model_name": model_name,
        "epoch": epoch,
    }))


def load_checkpoint(path: str, use_ema: bool = True,
                    map_location="cpu") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """-> (state_dict, meta): the EMA weights by default, as the JAX package
    restores them, on ``map_location``; ``meta`` is meta.json with the
    weights' class count under ``nc`` where meta.json names none."""
    p = Path(path).resolve()
    meta = json.loads((p / "meta.json").read_text())
    payload = torch.load(p / "state.pt", map_location=map_location, weights_only=True)
    meta.setdefault("nc", int(payload["nc"]))
    return payload["ema_params" if use_ema else "params"], meta


def restore_train_state(path: str, model: nn.Module, cfg, sample_images=None):
    """A training state restored from ``path`` into ``model`` (built for the
    checkpoint's model and class count, on its device): parameters and
    BatchNorm statistics, EMA, optimizer state (momentum buffers) and step,
    for a resume at epoch ``meta["epoch"] + 1`` (reference
    engine/trainer.py resume_training). ``sample_images`` is unused: the
    port's model needs no sample to build its state (the JAX package's
    signature). -> (TrainState, meta)."""
    from ..train.trainer import init_state, load_ema

    p = Path(path).resolve()
    meta = json.loads((p / "meta.json").read_text())
    device = next(model.parameters()).device
    payload = torch.load(p / "state.pt", map_location=device, weights_only=True)
    if "opt_state" not in payload:
        raise ValueError(f"{path} holds weights only (no optimizer state): it cannot resume")
    model.load_state_dict(payload["params"], strict=True)
    state = init_state(model, cfg)
    state.optimizer.load_state_dict(payload["opt_state"])
    load_ema(state, payload["ema_params"])
    state.step = int(payload["step"])
    meta.setdefault("nc", int(payload["nc"]))
    return state, meta


def checkpoint_name(path: str) -> str:
    """The ``train_args.name`` used in activation/threshold cache keys
    (reference ood_evaluation.py:296-300)."""
    meta = json.loads((Path(path) / "meta.json").read_text())
    return meta["train_args"].get("name", Path(path).stem)


def state_dict_equal(a: Mapping[str, torch.Tensor], b: Mapping[str, torch.Tensor]) -> bool:
    """Whether two state_dicts hold the same keys and bit-equal tensors
    (compared on the CPU)."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu()) for k in a)
