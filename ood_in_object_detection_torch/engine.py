"""Detector facade: one predict step with every OoD tap.

Port of ood_in_object_detection_tpu/engine.py. ``Detector.predict`` runs
normalise -> YOLO forward -> lazy DFL decode + top-k -> greedy NMS (kernel
K1) -> RoI and exact-position taps (kernel K2) -> box clip, and returns a
``PredictOutput`` with the JAX package's field set and layouts: images come
in as (B, H, W, 3), neck maps leave as (B, H/s, W/s, C) in the model's
compute dtype (bf16 with ``dtype=torch.bfloat16``, the JAX package's
``Detector.create(..., dtype=jnp.bfloat16)``); boxes, confidences and
logits leave in f32. ``Detector.step`` is the same step as a module with its
thresholds fixed, which ``utils/export.py`` exports.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch

from .models import build_model, init_weights
from .ops.fused_detect import fused_detect
from .ops.nms import Detections
from .ops.roi_align import roi_and_exact_batched


class PredictOutput(NamedTuple):
    det: Detections            # (B, max_det, ...) boxes xyxy / conf / cls / valid
    logits: torch.Tensor       # (B, max_det, nc) pre-sigmoid class logits per box
    stride_level: torch.Tensor  # (B, max_det) in {0, 1, 2}
    anchor_idx: torch.Tensor   # (B, max_det) flat anchor index
    roi_feats: torch.Tensor    # (B, max_det, Cmax) 1x1 RoI-aligned neck features
    exact_feats: torch.Tensor  # (B, max_det, Cmax) neck feature at the box's anchor cell
    neck: tuple                # 3 x (B, H/s, W/s, C_s) PAN neck maps

    @property
    def p3(self):
        return self.neck[0]


def normalise_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 images to f32 in [0, 1] on their device; other dtypes as they
    are. ``Detector.predict`` and a served bundle (serving.py) both take
    uint8 through this, outside the exported step."""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) * torch.tensor(1.0 / 255.0, device=x.device)
    return x


def model_maps(model: torch.nn.Module, x: torch.Tensor):
    """(B, H, W, 3) float images in [0, 1] -> (raw maps, neck maps), NCHW:
    the model part of the predict step."""
    # yolov10's raw maps are its one2one maps (a model in training
    # returns one2many third, as the JAX model_forward reads out[0] and
    # out[1], yolo.py:617); every family runs NMS
    return model(x.to(torch.float32).permute(0, 3, 1, 2).contiguous())[:2]


def predict_step(model: torch.nn.Module, x: torch.Tensor, conf_thres, iou_thres: float,
                 max_det: int, pre_nms_k: int, img_size: int, roi_samples: int) -> PredictOutput:
    """(B, H, W, 3) float images in [0, 1] -> PredictOutput: the body of
    ``Detector.predict`` and of the exported :class:`PredictStep`."""
    raw, neck = model_maps(model, x)
    return detect_and_tap(raw, neck, model.nc, conf_thres, iou_thres, max_det, pre_nms_k,
                          img_size, roi_samples)


def detect_and_tap(raw, neck, nc: int, conf_thres, iou_thres: float, max_det: int,
                   pre_nms_k: int, img_size: int, roi_samples: int) -> PredictOutput:
    """The post-model part of the predict step on whole maps: lazy decode,
    top-k and NMS (K1), the RoI and exact-position taps (K2), the clip."""
    ct = torch.as_tensor(conf_thres, dtype=torch.float32, device=raw[0].device)
    det, logits = fused_detect(raw, nc, ct, iou_thres=iou_thres,
                               max_det=max_det, pre_nms_k=pre_nms_k)
    # level from the flat anchor index against the level boundaries
    b0 = raw[0].shape[2] * raw[0].shape[3]
    b1 = b0 + raw[1].shape[2] * raw[1].shape[3]
    level = (det.anchor_idx >= b0).long() + (det.anchor_idx >= b1).long()
    neck = tuple(f.permute(0, 2, 3, 1).contiguous() for f in neck)
    roi, exact = roi_and_exact_batched(neck, det.boxes, det.anchor_idx, level,
                                       img_w=img_size, samples=roi_samples)
    # the reference RoI-aligns the UNclipped NMS boxes and clips after
    # (detect/predict.py:176-199, utils/ops.py:96,536)
    det = det._replace(boxes=det.boxes.clamp(0.0, float(img_size)))
    return PredictOutput(det, logits, level, det.anchor_idx, roi, exact, neck)


class PredictStep(torch.nn.Module):
    """The predict step with ``conf_thres``, ``iou_thres``, ``max_det`` and
    ``pre_nms_k`` fixed (the JAX package's ``Detector.predict_fn``, its
    threshold baked in): ``forward`` takes f32 (B, H, W, 3) images in
    [0, 1] and returns a PredictOutput. ``utils/export.py`` exports it."""

    def __init__(self, model: torch.nn.Module, img_size: int, roi_samples: int = 0,
                 conf_thres: float = 0.25, iou_thres: float = 0.7, max_det: int = 300,
                 pre_nms_k: int = 1024):
        super().__init__()
        self.model = model
        self.img_size, self.roi_samples = img_size, roi_samples
        self.conf_thres, self.iou_thres = float(conf_thres), float(iou_thres)
        self.max_det, self.pre_nms_k = max_det, pre_nms_k

    def forward(self, images: torch.Tensor) -> PredictOutput:
        return predict_step(self.model, images, self.conf_thres, self.iou_thres, self.max_det,
                            self.pre_nms_k, self.img_size, self.roi_samples)


@dataclasses.dataclass
class Detector:
    """Build with ``Detector.create('yolov8l', nc=20)`` (on the card)."""

    model: torch.nn.Module
    img_size: int = 640
    # 0 = torchvision's adaptive ceil(roi_span) sampling (the reference's
    # roi_align default, predict.py:64-70); >0 = fixed SxS grid
    roi_samples: int = 0
    # predict_sharded's replicas: (mesh, weights key, {device: model})
    _replicas: Any = dataclasses.field(default=None, repr=False, compare=False)
    # predict_sharded's last sp run: per batch shard, its shards' ShardStats
    last_sp_stats: Any = dataclasses.field(default=None, repr=False, compare=False)
    # predict_sharded's sp threads (parallel/spatial.py:Workers), made on first use
    _sp_workers: Any = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def create(cls, name: str, nc: int = 80, img_size: int = 640, device="cuda",
               generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32,
               state_dict: Optional[Mapping] = None) -> "Detector":
        """A seeded random init from ``generator`` (seed 0 by default), or
        the weights of ``state_dict`` (ultralytics names, loaded strictly: a
        checkpoint's, core/checkpoint.py:load_checkpoint, as the JAX
        package's ``create(..., variables=)``), made on the CPU and moved to
        ``device``: the card unless the caller passes ``device="cpu"``
        (plain PyTorch versions of the kernels). ``dtype`` is the compute
        dtype (engine.py:90-91 of the JAX package); the parameters stay
        f32."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector.create: CUDA is not available; pass device=\"cpu\" "
                               "to run the plain PyTorch versions of the kernels on the CPU")
        model = build_model(name, nc=nc, dtype=dtype)
        if state_dict is None:
            init_weights(model, generator or torch.Generator().manual_seed(0))
        else:
            model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                  strict=True)
        return cls(model=model.to(device).eval(), img_size=img_size)

    @property
    def nc(self) -> int:
        return self.model.nc

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step(self, conf_thres: float = 0.25, iou_thres: float = 0.7, max_det: int = 300,
             pre_nms_k: int = 1024) -> "PredictStep":
        """The predict step as a module with its thresholds fixed: what
        ``utils/export.py`` exports (the JAX package's ``predict_fn``)."""
        return PredictStep(self.model, img_size=self.img_size, roi_samples=self.roi_samples,
                           conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                           pre_nms_k=pre_nms_k)

    @torch.no_grad()
    def predict(self, images, conf_thres=0.25, iou_thres: float = 0.7, max_det: int = 300,
                pre_nms_k: int = 1024) -> PredictOutput:
        """(B, H, W, 3) uint8 (normalised here, on the device) or float images
        in [0, 1] -> PredictOutput. ``conf_thres`` may be a 0-dim tensor."""
        x = normalise_images(torch.as_tensor(images).to(self.device))
        return predict_step(self.model, x, conf_thres, iou_thres, max_det, pre_nms_k,
                            self.img_size, self.roi_samples)

    def _replicas_for(self, mesh) -> dict:
        """{device: model} for every device the mesh's work runs on (each
        batch shard's ``sp`` entries at ``model`` index 0): the model itself
        on its own device, elsewhere a copy made once per mesh and weights
        (the JAX package's replicated weights, engine.py:195-203). The cache
        holds one entry, keyed by the mesh (identity) and every parameter's
        and buffer's storage and version counter, so loading or calibrating
        weights in place evicts it. A mesh of the model's own device alone
        needs no copy and no key (the key costs ~2 ms of host time at
        yolov8l). The shards of an ``sp`` group on one device share its
        replica (an eval forward writes nothing to the model)."""
        own = self.device
        used = [d for g in mesh.sp_groups for d in g]
        if all(d == own for d in used):
            return {own: self.model}
        key = tuple((t.data_ptr(), t._version)
                    for t in itertools.chain(self.model.parameters(), self.model.buffers()))
        cached = self._replicas
        if cached is not None and cached[0] is mesh and cached[1] == key:
            return cached[2]
        reps = {}
        with torch.no_grad():
            for d in used:
                if d not in reps:
                    reps[d] = self.model if d == own else copy.deepcopy(self.model).to(d).eval()
        self._replicas = (mesh, key, reps)
        return reps

    @torch.no_grad()
    def predict_sharded(self, images, mesh, conf_thres=0.25, iou_thres: float = 0.7,
                        max_det: int = 300, pre_nms_k: int = 1024) -> PredictOutput:
        """Predict over a ("dcn", "data", "sp", "model") mesh
        (parallel/mesh.py) from one process: the batch splits into the
        mesh's ("dcn", "data") shards, equal and contiguous, in order, and
        the outputs are gathered onto the mesh's first device in batch
        order. A batch that does not divide over the shards raises
        ValueError, as the JAX package's device_put does.

        - ``sp`` 1: each shard runs the unchanged predict step on its
          device's replica of the model (K4, K1, K2 launch there).
        - ``sp`` above 1: each shard's image height splits into equal slabs
          over its ``sp`` entries (parallel/spatial.py: a whole number of
          rows at the model's largest stride, else ValueError naming the
          heights). One thread a slab runs the model forward on its rows,
          K4 on its slab, the layers exchanging their halos by hand; the
          raw and neck maps are gathered onto the shard's first ``sp`` entry,
          which runs the post-model part (K1, K2, the clip) once.
        - ``model``: splits no work, as the JAX predict replicates the
          weights over the whole mesh: each (batch shard, ``sp``) position
          runs on its ``model``-index-0 entry.

        With ``sp`` above 1, ``self.last_sp_stats`` holds each group's
        per-shard exchange counts, halo rows and bytes and barrier waits
        (parallel/spatial.py:ShardStats)."""
        from .models.head import STRIDES
        from .parallel import spatial
        from .parallel.mesh import batch_sharding

        sharding = batch_sharding(mesh)
        x = torch.as_tensor(images)
        rows = sharding.slices(x.shape[0])
        groups = mesh.sp_groups
        reps = self._replicas_for(mesh)
        if len(groups[0]) == 1:
            outs = []
            for sl, dev in zip(rows, sharding.devices):
                with (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                    xs = normalise_images(x[sl].to(dev))
                    outs.append(predict_step(reps[dev], xs, conf_thres, iou_thres, max_det,
                                             pre_nms_k, self.img_size, self.roi_samples))
            return _gather(outs, sharding.devices[0])
        spans = spatial.row_spans(x.shape[1], len(groups[0]), max(STRIDES))
        overlaps = [0] + [spatial.STEM_OVERLAP] * (len(spans) - 1)

        def forward(slab):
            xs = normalise_images(slab.to(spatial.current().device))
            return model_maps(reps[spatial.current().device], xs)

        jobs = [(spatial.SpGroup(g), forward,
                 [x[sl, lo - ov:hi] for (lo, hi), ov in zip(spans, overlaps)], overlaps)
                for sl, g in zip(rows, groups)]
        if self._sp_workers is None:
            self._sp_workers = spatial.Workers()
        results = spatial.run(jobs, workers=self._sp_workers)
        self.last_sp_stats = [job[0].stats for job in jobs]
        outs = []
        for g, parts in zip(groups, results):
            dev = g[0]
            with (torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()):
                raw, neck = (_gather_rows([p[i] for p in parts], dev) for i in range(2))
                outs.append(detect_and_tap(raw, neck, self.nc, conf_thres, iou_thres, max_det,
                                           pre_nms_k, self.img_size, self.roi_samples))
        return _gather(outs, sharding.devices[0])

    def neck_channels(self) -> Tuple[int, ...]:
        """Per-level neck channel counts (to slice roi_feats padding)."""
        return tuple(self.model.neck_channels)


def _gather_rows(parts, device):
    """The ``sp`` shards' lists of NCHW maps, in height order, each map's
    rows concatenated on ``device``."""
    return [torch.cat([p[i].to(device) for p in parts], dim=2) for i in range(len(parts[0]))]


def _gather(parts, device):
    """The shards' outputs (equal nested tuples of tensors) concatenated
    along the batch on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return first.to(device) if len(parts) == 1 else torch.cat([p.to(device) for p in parts])
    fields = [_gather([p[i] for p in parts], device) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
