"""Logit-based OoD scores (port of ood_in_object_detection_tpu/ood/scores.py).

- MSP:     softmax(logits)[cls]                      (ood_utils.py:1394-1397)
- Energy:  T * logsumexp(logits / T)                 (ood_utils.py:1400-1412)
- ODIN:    softmax(logits / T)[cls]                  (ood_utils.py:1415-1427)
- Sigmoid: sigmoid(logit)[cls]                       (ood_utils.py:1430-1443)
- NoMethod: constant 1 (always in-distribution)      (ood_utils.py:1366-1384)

Each takes (..., nc) pre-sigmoid logits and (...,) predicted classes.
"""

from __future__ import annotations

import torch

LOGITS_METHODS = ("NoMethod", "MSP", "Energy", "ODIN", "Sigmoid")


def _take_cls(values: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    return torch.gather(values, -1, cls.long()[..., None])[..., 0]


def table_lookup(table: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``table[idx0]`` or ``table[idx0, idx1]`` (NaN entries propagate)."""
    return table[tuple(i.long() for i in idx)]


def msp_score(logits, cls):
    return _take_cls(torch.softmax(logits.float(), dim=-1), cls)


def energy_score(logits, cls, temper: float = 1.0):
    return temper * torch.logsumexp(logits.float() / temper, dim=-1)


def odin_score(logits, cls, temper: float = 1000.0):
    return _take_cls(torch.softmax(logits.float() / temper, dim=-1), cls)


def sigmoid_score(logits, cls):
    return _take_cls(torch.sigmoid(logits.float()), cls)


def no_method_score(logits, cls):
    return torch.ones(logits.shape[:-1], dtype=torch.float32, device=logits.device)


def logits_score_fn(name: str, temper: float = 1.0):
    """score(logits, cls) for a logits-method name; ``temper`` as given."""
    if name == "MSP":
        return msp_score
    if name == "Energy":
        return lambda l, c: energy_score(l, c, temper)
    if name == "ODIN":
        return lambda l, c: odin_score(l, c, temper)
    if name == "Sigmoid":
        return sigmoid_score
    if name == "NoMethod":
        return no_method_score
    raise ValueError(f"unknown logits method {name}")
