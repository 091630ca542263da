"""The system under test, built for a cell from its seed.

The benchmark makes the weights (``reference/model.py:init_from_seed``, on
the card, from a ``torch.Generator`` seeded with ``--seed``) and the scenes,
and hands the same to both sides: the state dict to the program's
``Detector.create(state_dict=...)``, the InD scenes to the program's fit
(``extract_ind_activations`` and ``fit_ind_pipeline`` on batches labelled by
its own detections, as ``chip_smoke.py`` labels them) and to the
reference's own fit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from . import scenes
from .reference import model as M
from .reference.pipeline import Reference

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TPR = 0.95


@dataclasses.dataclass
class Inputs:
    reference: Reference
    state_dict: dict
    ind: List[np.ndarray]


def make_inputs(cell, seed: int, device) -> tuple:
    """(Inputs, generator): the reference model with the seed's weights and
    the InD batches; the generator goes on to draw the traffic's scenes."""
    cfg, wl = cell.config, cell.workload
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = cfg["img_size"]
    calib = torch.from_numpy(scenes.make_scenes(gen, wl["calib_images"], img)).to(dev)
    model = M.build(cfg, dev)
    M.init_from_seed(model, gen, calib.permute(0, 3, 1, 2).float() / 255.0,
                     wl.get("head_init", "spread"))
    del calib
    ind = [scenes.make_scenes(gen, wl["ind_batch"], img) for _ in range(wl["ind_batches"])]
    return Inputs(Reference(model, cfg, wl), M.state_dict(model), ind), gen


@dataclasses.dataclass
class Program:
    detector: Any
    method: Any
    neck_channels: tuple
    predict: Any  # images -> PredictOutput, as ood/pipeline.py:_predict_step calls it


def build_program(cell, inputs: Inputs, device) -> Program:
    """The port's Detector on the seed's weights and its fitted OoD method."""
    from ood_in_object_detection_torch.engine import Detector
    from ood_in_object_detection_torch.ood.methods import DistanceOODMethod, LogitsOODMethod
    from ood_in_object_detection_torch.ood.pipeline import (_np, extract_ind_activations,
                                                            fit_ind_pipeline)

    cfg, wl = cell.config, cell.workload
    det = Detector.create(cfg["program_model"], nc=cfg["nc"], img_size=cfg["img_size"],
                          device=device, dtype=DTYPES[wl["dtype"]], state_dict=inputs.state_dict)

    def predict(images):
        return det.predict(images, conf_thres=wl["conf_thres"], iou_thres=wl["iou_thres"],
                           max_det=wl["max_det"], pre_nms_k=wl["pre_nms_k"])

    def label(images):
        out = predict(images)
        return _np(out.det.boxes), _np(out.det.cls), _np(out.det.valid)

    batches = scenes.label_batches(label, inputs.ind, wl["conf_thres"], wl["max_gt"], cfg["nc"])
    if wl["method"] == "MSP":
        method = LogitsOODMethod("MSP")
    else:
        method = DistanceOODMethod.from_name(wl["method"], cluster_method=wl["cluster_method"])
    acts = extract_ind_activations(det, batches, method, conf_thr_train=wl["conf_thres"])
    fit_ind_pipeline(method, acts, tpr=TPR)
    return Program(det, method, det.neck_channels(), predict)


def record(out, decisions) -> dict:
    """The per-box record of one PredictOutput and its decisions (host
    arrays; the neck maps stay on the device, NCHW f32)."""
    def host(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    return dict(valid=host(out.det.valid), anchor=host(out.anchor_idx), boxes=host(out.det.boxes),
                conf=host(out.det.conf), cls=host(out.det.cls), logits=host(out.logits),
                roi=host(out.roi_feats), exact=host(out.exact_feats), decision=host(decisions),
                neck=[n.permute(0, 3, 1, 2).float() for n in out.neck])
