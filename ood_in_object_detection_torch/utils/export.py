"""Model export and the serving bundle (port of
ood_in_object_detection_tpu/utils/export.py, function by function).

The predict step (``engine.PredictStep``: forward, NMS, RoI and exact taps)
is exported with ``torch.export``, its weights in the program. Kernels K4,
K1 and K2 are operators (``ops/library.py``), so the graph holds them as
calls of ``ood_torch::fused_stem``, ``nms_keep`` and ``roi_contract``, and
the device of the inputs picks the implementation when the graph runs: the
kernels on the card, their plain versions on the CPU. One artifact thereby
serves on both, the JAX module's ``platforms=("cpu", "tpu")`` contract.
The program is saved on the CPU and moved to the serving device at load
(``torch.export.passes.move_to_device_pass``), constants and device
arguments included.

    export_graph_text      the exported program's printed graph (JAX: export_stablehlo)
    export_serialized      a .pt2 round-trippable program (torch.export.save)
    export_serving_bundle  model.pt2 + the fitted OoD method + bundle.json
    load_serving_bundle    -> (call, method, meta), no model code, no checkpoint
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Optional, Sequence

import torch

PLATFORMS = ("cpu", "cuda")


def register_output_types() -> None:
    """Name the predict step's NamedTuple outputs for ``torch.export.save``
    and ``load`` (idempotent); the JAX module's ``_register_output_types``."""
    import torch.utils._pytree as pytree

    from ..engine import PredictOutput
    from ..ops.nms import Detections

    for cls, name in ((Detections, "ood_torch.Detections"),
                      (PredictOutput, "ood_torch.PredictOutput")):
        if cls not in pytree.SUPPORTED_NODES:
            pytree._register_namedtuple(cls, serialized_type_name=name)


def _check_platforms(platforms: Sequence[str]) -> None:
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got "
                         f"{list(platforms)}")


def export_program(detector, batch: int = 1, conf_thres: float = 0.25):
    """``torch.export`` of ``detector.step(conf_thres)`` on f32 (batch, S, S, 3)
    images in [0, 1] on the detector's device -> ExportedProgram, moved to
    the CPU. The fake implementations of the operators refuse, here, a stem
    K4 does not take and a map past K2's cells."""
    from torch.export.passes import move_to_device_pass

    register_output_types()
    s = detector.img_size
    example = torch.zeros((batch, s, s, 3), dtype=torch.float32, device=detector.device)
    with torch.no_grad():
        program = torch.export.export(detector.step(conf_thres=conf_thres).eval(), (example,))
    # not saved with the program: the zero batch (39 MB at 8 x 640 px) is a
    # shape, which the program's input spec already holds
    program.example_inputs = None
    return move_to_device_pass(program, "cpu")


def export_graph_text(detector, out_path, batch: int = 1) -> Path:
    """The exported predict step's printed graph (ATen and ``ood_torch``
    operators) -> ``out_path``."""
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(str(export_program(detector, batch=batch)))
    return p


def export_serialized(detector, out_path, batch: int = 1, conf_thres: float = 0.25,
                      platforms=PLATFORMS) -> Path:
    """A ``torch.export.save`` artifact of the predict step, weights in the
    program, ``conf_thres`` fixed; it runs on every device of
    ``platforms`` (the operators dispatch on the device)."""
    _check_platforms(platforms)
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(export_program(detector, batch=batch, conf_thres=conf_thres), str(p))
    return p


def _refuse_sdr(method) -> None:
    """An SDR method's embedders are fitted networks applied by a
    process-local closure (ood/sdr.py): no bundle carries them."""
    from ..ood.pipeline import _leaf_methods

    for m in _leaf_methods(method):
        if getattr(m, "transform_fn", None) is not None or getattr(m, "sdr_state", None):
            raise ValueError(f"this method cannot be bundled: {m.name} carries a fitted SDR "
                             "embedding (a process-local transform), which a serving bundle "
                             "does not hold")


def export_serving_bundle(detector, method, out_dir, batch: int = 1,
                          conf_thres: float = 0.25, platforms=PLATFORMS) -> Path:
    """One deployable directory: ``model.pt2`` (the exported predict step),
    ``ood_method.pkl`` (the FITTED OoD method, when given) and
    ``bundle.json`` (img_size, batch, nc, conf_thres, platforms,
    neck_channels). A serving process (``load_serving_bundle``,
    ``serving.MicroBatchServer.from_bundle``) needs no model code and no
    checkpoint. SDR methods are refused (ValueError)."""
    if method is not None:
        _refuse_sdr(method)
    p = Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    export_serialized(detector, p / "model.pt2", batch=batch, conf_thres=conf_thres,
                      platforms=platforms)
    if method is not None:
        (p / "ood_method.pkl").write_bytes(pickle.dumps(method))
    (p / "bundle.json").write_text(json.dumps({
        "img_size": detector.img_size,
        "batch": batch,
        "nc": detector.nc,
        "conf_thres": conf_thres,
        "platforms": list(platforms),
        "neck_channels": [int(c) for c in detector.neck_channels()],
    }))
    return p


def load_serving_bundle(path, device: Optional[str] = None):
    """-> (call, fitted method or None, meta). ``call`` maps f32
    (batch, S, S, 3) images in [0, 1] on ``device`` to a PredictOutput: the
    exported program moved to ``device``, the card unless the caller passes
    ``device="cpu"``; a device type the bundle's ``platforms`` does not list
    is refused. Per-box verdicts come from
    ``ood.pipeline._decisions_for_method(method, out, meta['neck_channels'])``;
    a distance method rebuilds its centroid bank on the serving device at
    first use."""
    from torch.export.passes import move_to_device_pass

    from ..ops import library  # noqa: F401 (registers the ood_torch operators)

    register_output_types()
    p = Path(path)
    meta = json.loads((p / "bundle.json").read_text())
    meta["neck_channels"] = tuple(meta["neck_channels"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"bundle {p} serves on {meta['platforms']}, not {dev.type}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_serving_bundle: CUDA is not available; pass device=\"cpu\" "
                           "to serve the plain PyTorch versions on the CPU")
    program = torch.export.load(str(p / "model.pt2"))
    if dev.type != "cpu":
        program = move_to_device_pass(program, dev)
    call = program.module().requires_grad_(False)
    method = None
    if (p / "ood_method.pkl").exists():
        method = pickle.loads((p / "ood_method.pkl").read_bytes())
    return call, method, meta


__all__ = ["export_graph_text", "export_serialized", "export_serving_bundle",
           "load_serving_bundle", "register_output_types"]
