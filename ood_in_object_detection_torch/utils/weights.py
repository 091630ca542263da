"""Weights across the two packages.

The JAX package's ``utils/weight_import.py:export_state_dict(variables,
detect_layer_idx)`` (the port model's ``detect_layer_idx``: 22 for yolov8)
writes an ultralytics-named, torch-layout numpy state_dict; this port
names its modules the same way, so that dict loads with ``strict=True``
and no renaming table. An ultralytics ``.pt`` is read by
:func:`state_dict_from_torch_file` and loaded by
:func:`load_torch_state_dict`, the port's counterparts of the JAX
package's ``state_dict_from_torch_file`` and ``import_state_dict``.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

# the detect head's final 1x1 convs: box (cv2) and class (cv3) outputs,
# and yolov10's one2one copies of them (its inference branch)
HEAD_OUTPUT_KEY = re.compile(r"^model\.\d+\.(one2one_)?cv([23])\.\d\.2\.(weight|bias)$")
BOX_BIN_SLOPE = 0.5  # spread_detect_head: DFL bias drop per bin


def load_jax_variables(model: nn.Module, state_dict: Dict[str, np.ndarray]) -> nn.Module:
    """Load a numpy state_dict exported from the JAX variables (strict)."""
    sd = {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    return model


def sdr_params_from_jax(params: List[Mapping[str, np.ndarray]], device="cpu"):
    """An ``ood/sdr.py:TripletEmbedder`` holding the JAX package's SDR MLP
    parameters, ``[{"w": (in, out), "b": (out,)}, ...]`` as numpy arrays:
    ``w`` is transposed into ``Linear.weight`` (out, in)."""
    from ..ood.sdr import TripletEmbedder

    widths = [int(np.shape(params[0]["w"])[0])] + [int(np.shape(p["w"])[1]) for p in params]
    emb = TripletEmbedder(widths)
    with torch.no_grad():
        for layer, p in zip(emb.layers, params):
            layer.weight.copy_(torch.as_tensor(np.asarray(p["w"], np.float32).T))
            layer.bias.copy_(torch.as_tensor(np.asarray(p["b"], np.float32)))
    return emb.to(device).eval()


def class_count(state_dict: Mapping) -> int:
    """The class count of a detector's state_dict: the length of the class
    tower's last bias, ``cv3.0.2.bias`` (the JAX predict CLI's reading,
    cli/predict.py:155-157)."""
    keys = sorted(k for k in state_dict if k.endswith("cv3.0.2.bias"))
    if not keys:
        raise KeyError("no detect head class bias (*cv3.0.2.bias) in the state_dict")
    return int(state_dict[keys[0]].shape[0])


def state_dict_from_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A flat state_dict (tensors as f32, on the CPU) from a ``.pt`` file:
    its ``ema``, else its ``model``, else the file itself as a state_dict,
    each a module or a state_dict (the JAX package's
    utils/weight_import.py:199-210). An ultralytics checkpoint pickles its
    modules, so the file is unpickled whole (``weights_only=False``): read
    only files you trust, and one that pickles ultralytics modules needs
    that package importable."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    model = obj
    if isinstance(obj, dict):
        model = obj.get("ema") or obj.get("model") or obj
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    return {k: v.float() for k, v in sd.items()}


def load_torch_state_dict(model: nn.Module, state_dict: Mapping,
                          strict: bool = False) -> List[str]:
    """Load the tensors (torch or numpy) of ``state_dict`` whose names the
    model has; -> the model's keys that ``state_dict`` lacks, which keep
    their values (logged), as the JAX package's ``import_state_dict``
    returns them. A shape that differs raises; with ``strict`` a missing
    key raises."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    if strict and missing:
        raise KeyError(f"{len(missing)} torch keys not found, e.g. {missing[:5]}")
    with torch.no_grad():
        for k, dst in own.items():
            if k in missing:
                continue
            v = state_dict[k]
            src = torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {k}: file {tuple(src.shape)} vs model "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    if missing:
        logging.getLogger(__name__).warning("%d torch keys not matched (first: %s)",
                                            len(missing), missing[:3])
    return missing


def numpy_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, images: torch.Tensor) -> nn.Module:
    """Set every BatchNorm's running statistics to those of one forward of
    ``images`` (B, 3, H, W), layer by layer, as a trained model's would
    normalise its activations. A random-init model with identity BN shrinks
    its activations towards zero with depth, so every anchor would get the
    same box and confidence; after this pass each channel is unit-scale.
    The model is left in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch -> its statistics
    model.train()
    try:
        model(images)
    finally:
        for m, mom in zip(bns, saved):
            m.momentum = mom
        model.eval()
    return model


def spread_detect_head(state_dict: Dict[str, np.ndarray], seed: int,
                       scale: float = 4.0) -> Dict[str, np.ndarray]:
    """Seeded spread of the detect head's final 1x1 convs, for random-init
    models whose confidences and boxes would otherwise be tie-degenerate:
    each output channel's weights are scaled by U(0.5, 1.5) * ``scale`` and
    its bias redrawn from N(0, 1). Box (DFL) biases also fall by
    BOX_BIN_SLOPE per bin, so that boxes span a few cells rather than half
    the image. The same numpy dict loads into both packages, so both
    see identical weights. Returns a new dict."""
    rng = np.random.default_rng(seed)
    out = dict(state_dict)
    for k in sorted(state_dict):
        if not HEAD_OUTPUT_KEY.match(k):
            continue
        v = np.asarray(state_dict[k], np.float32)
        if k.endswith("weight"):
            f = rng.uniform(0.5, 1.5, v.shape[0]).astype(np.float32) * np.float32(scale)
            out[k] = v * f.reshape(-1, 1, 1, 1)
        else:
            b = rng.normal(0.0, 1.0, v.shape)
            if HEAD_OUTPUT_KEY.match(k).group(2) == "2":  # 4 sides x REG_MAX bins
                b -= BOX_BIN_SLOPE * (np.arange(v.shape[0]) % (v.shape[0] // 4))
            out[k] = b.astype(np.float32)
    return out


def graft_classification_backbone(model: nn.Module, pt_path: str, max_layer: int = 6) -> int:
    """Load a classification checkpoint's backbone (layers 0..max_layer)
    into a detector, leaving every other tensor as it is (reference
    custom_training.py:129-133: the yolov8{size}-cls ``model[:7]``
    state_dict loaded with strict=False; the cls and detect yamls share the
    backbone through layer 6; the JAX package's
    utils/weight_import.py:213-242). -> the count of grafted tensors
    (parameters and BatchNorm statistics, as the JAX package counts its
    leaves). Raises where the file has no such keys or none matches."""
    sd = state_dict_from_torch_file(pt_path)
    pat = re.compile(r"^model\.(\d+)\.")
    keep = {k: v for k, v in sd.items()
            if (m := pat.match(k)) and int(m.group(1)) <= max_layer}
    if not keep:
        raise ValueError(f"{pt_path} has no model.0..{max_layer} backbone keys")
    own = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")
           and not k.endswith(".dfl.conv.weight")]
    grafted = [k for k in own if k in keep]
    if not grafted:
        raise ValueError(f"no tensors from {pt_path} matched the detector backbone "
                         "(shape/naming mismatch?)")
    load_torch_state_dict(model, {k: keep[k] for k in grafted})
    return len(grafted)
