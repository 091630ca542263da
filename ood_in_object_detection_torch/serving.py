"""Dynamic micro-batching for online serving (port of
ood_in_object_detection_tpu/serving.py).

Concurrent single-image requests are coalesced into fixed-batch predict
steps on the device:

- a request enqueues an (image, Future) pair and blocks on the future;
- a collector thread takes the first request, waits at most
  ``max_wait_ms`` for more, up to ``batch_size`` (the latency/throughput
  knob), zero-pads the group to ``batch_size``, and runs one
  ``Detector.predict`` (K4, K1, K2 on the card) and, with a fitted OoD
  method, its per-box decisions (K3 for the distance methods);
- ``MicroBatchServer.from_bundle`` serves a bundle of ``utils/export.py``
  instead of a live detector: the exported step (the same kernels, as
  operators) and the bundled fitted method, no model code;
- each future resolves to its image's slice of the batched output; the
  padding rows are computed and dropped.

Every step runs at one batch size, so the kernels see one set of shapes.
One process drives one card, or a mesh (parallel/mesh.py) through
``Detector.predict_sharded`` (pass ``mesh=``: the batch splits over its
("dcn", "data") shards and each image's height over an ``sp`` axis, each
device runs its part on its replica, the outputs and the decisions land on
the mesh's first device). The collector thread serializes the
device work and runs it without autograd (grad mode is per thread in
PyTorch).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from .engine import normalise_images


@dataclass
class _Request:
    image: np.ndarray
    future: "Future[Any]"


class _BundleModel:
    """Detector-shaped shim over a loaded serving bundle
    (``utils.export.load_serving_bundle``): the ``img_size``, ``nc``,
    ``device``, ``neck_channels()`` and ``predict()`` that MicroBatchServer
    drives, backed by the exported predict step (weights in the program:
    the serving process builds no model and reads no checkpoint)."""

    def __init__(self, call, meta: dict, device):
        self._call = call
        self._meta = meta
        self.img_size = int(meta["img_size"])
        self.nc = int(meta["nc"])
        self.device = torch.device(device)

    def neck_channels(self):
        return tuple(self._meta["neck_channels"])

    def predict(self, images, conf_thres: float = 0.25, pre_nms_k: int = 1024):
        """The exported step on (B, H, W, 3) images: uint8 normalised on the
        device as ``Detector.predict`` does, outside the program (it was
        exported on f32 images in [0, 1]). ``conf_thres`` and ``pre_nms_k``
        are fixed in the program (bundle.json records the threshold) and
        accepted for API parity only."""
        x = normalise_images(torch.as_tensor(images).to(self.device))
        return self._call(x.to(torch.float32))


@dataclass
class MicroBatchServer:
    """Coalesce concurrent single-image predict requests into fixed-batch
    device steps. ``detector`` is an ``engine.Detector``; images are HWC
    uint8 (normalized on the device) or float32 in [0, 1], at the detector's
    ``img_size``."""

    detector: Any
    batch_size: int = 8
    max_wait_ms: float = 2.0
    conf_thres: float = 0.25
    mesh: Any = None
    pre_nms_k: int = 1024
    # optional FITTED OoD method (logits/distance/fusion, after
    # fit_ind_pipeline): each result then carries a per-box ``is_ood`` verdict
    ood_method: Any = None
    _q: "queue.Queue[Optional[_Request]]" = field(default_factory=queue.Queue)
    _thread: Optional[threading.Thread] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _closed: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            from .models.head import STRIDES
            from .parallel.mesh import batch_sharding
            from .parallel.spatial import row_spans

            batch_sharding(self.mesh).slices(self.batch_size)  # must divide
            row_spans(self.detector.img_size, self.mesh.shape["sp"], max(STRIDES))  # must split

    @classmethod
    def from_bundle(cls, path, device=None, **kw) -> "MicroBatchServer":
        """Serve an ``utils.export.export_serving_bundle`` directory with no
        model code: the batch size, the confidence threshold and the fitted
        OoD method come from the bundle (a ``batch_size`` or ``conf_thres``
        that differs raises, as the program is fixed at both); the program
        runs on the card unless ``device="cpu"``; pass ``max_wait_ms`` etc.
        through ``kw``."""
        from .utils.export import load_serving_bundle

        if kw.get("mesh") is not None:
            raise ValueError("bundles are single-program artifacts; "
                             "mesh serving needs a live Detector")
        call, method, meta = load_serving_bundle(path, device=device)
        if kw.get("batch_size", int(meta["batch"])) != int(meta["batch"]):
            raise ValueError(
                f"bundle was exported at batch={meta['batch']}; the exported "
                "program is fixed-shape: re-export for another batch")
        if abs(kw.get("conf_thres", float(meta["conf_thres"]))
               - float(meta["conf_thres"])) > 1e-9:
            raise ValueError(
                f"bundle was exported at conf_thres={meta['conf_thres']}; the "
                "threshold is fixed in the program: re-export to change it")
        kw.setdefault("batch_size", int(meta["batch"]))
        kw.setdefault("conf_thres", float(meta["conf_thres"]))
        kw.setdefault("ood_method", method)
        dev = "cuda" if device is None else device
        return cls(detector=_BundleModel(call, meta, dev), **kw)

    def start(self) -> "MicroBatchServer":
        """Start the collector thread and return once it has warmed up: one
        full-batch uint8 step (the serving dtype) in that thread, so the
        kernels' build, their first launches and the thread's own cuBLAS
        and cuDNN handles come before the first request. A warm-up that
        raises stops the thread and raises here."""
        self._closed = False
        ready, failed = threading.Event(), []
        self._thread = threading.Thread(target=self._loop, args=(ready, failed), daemon=True)
        self._thread.start()
        ready.wait()
        if failed:
            self._thread.join()
            self._thread = None
            raise failed[0]
        return self

    def stop(self) -> None:
        with self._lock:
            if self._thread is None:
                return
            # flag first so no submit can enqueue behind the sentinel;
            # requests queued before it are still served
            self._closed = True
            self._q.put(None)
        self._thread.join()
        self._thread = None
        # fail anything that raced past _collect's sentinel
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("MicroBatchServer stopped"))

    def __enter__(self) -> "MicroBatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- client API ----

    def submit(self, image: np.ndarray) -> "Future[Any]":
        """Enqueue one HWC image; the future resolves to that image's slice
        of the batched PredictOutput as a dict of numpy arrays."""
        with self._lock:
            if self._closed or self._thread is None:
                raise RuntimeError("server not running")
            fut: "Future[Any]" = Future()
            self._q.put(_Request(np.asarray(image), fut))
        return fut

    def predict_one(self, image: np.ndarray) -> Any:
        return self.submit(image).result()

    # ---- server side ----

    def _predict(self, images):
        if self.mesh is not None:
            return self.detector.predict_sharded(images, self.mesh, conf_thres=self.conf_thres,
                                                 pre_nms_k=self.pre_nms_k)
        return self.detector.predict(images, conf_thres=self.conf_thres,
                                     pre_nms_k=self.pre_nms_k)

    def _run(self, imgs: np.ndarray):
        """One device step on a full batch -> (PredictOutput, OoD decisions
        or None)."""
        out = self._predict(imgs)
        ood = None
        if self.ood_method is not None:
            from .ood.pipeline import _decisions_for_method

            ood = _decisions_for_method(self.ood_method, out, self.detector.neck_channels())
        return out, ood

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first request, then drain up to batch_size within
        max_wait_ms. None = shutdown sentinel."""
        first = self._q.get()
        if first is None:
            return None
        group = [first]
        deadline = max(self.max_wait_ms, 0.0) / 1000.0
        t0 = time.perf_counter()
        while len(group) < self.batch_size:
            remaining = deadline - (time.perf_counter() - t0)
            try:
                nxt = self._q.get_nowait() if remaining <= 0 else self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # re-post shutdown for the outer loop
                self._q.put(None)
                break
            group.append(nxt)
        return group

    def _warm_up(self) -> None:
        s = self.detector.img_size
        self._run(np.zeros((self.batch_size, s, s, 3), np.uint8))
        devices = ([self.detector.device] if self.mesh is None
                   else set(self.mesh.devices.reshape(-1)))
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _loop(self, ready: threading.Event, failed: list) -> None:
        with torch.no_grad():  # grad mode is per thread
            try:
                self._warm_up()
            except Exception as e:  # reported by start()
                failed.append(e)
                return
            finally:
                ready.set()
            while True:
                group = self._collect()
                if group is None:
                    return
                try:
                    arrs = [r.image for r in group]
                    if len({a.dtype for a in arrs}) > 1:
                        # mixed u8/f32 group: np.stack would promote u8 values
                        # to float without the /255 of the u8 branch, so
                        # normalize on the host: every image means the same
                        arrs = [a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else
                                np.asarray(a, np.float32) for a in arrs]
                    imgs = np.stack(arrs)
                    if len(group) < self.batch_size:  # pad to the serving batch
                        pad = np.zeros((self.batch_size - len(group),) + imgs.shape[1:],
                                       imgs.dtype)
                        imgs = np.concatenate([imgs, pad])
                    out, ood = self._run(imgs)
                    results = _split_output(out, len(group), ood)
                    for r, res in zip(group, results):
                        r.future.set_result(res)
                except Exception as e:  # fail the whole group, keep serving
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)


def _split_output(out, n: int, ood=None) -> List[dict]:
    """Per-image numpy dicts from the batched PredictOutput (first n rows).
    The batch's tensors come to the host in one copy (one synchronize):
    flattened, cast to f32 (exact for the boxes, scores, logits, classes,
    masks and decisions) and concatenated on the device, then sliced on the
    host."""
    payload = [out.det.boxes, out.det.conf, out.det.cls, out.det.valid, out.logits]
    if ood is not None:
        payload.append(ood)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in payload]).cpu().numpy()
    parts, off = [], 0
    for t in payload:
        parts.append(flat[off:off + t.numel()].reshape(t.shape)[:n])
        off += t.numel()
    boxes, conf, cls, valid, logits = parts[:5]
    valid = valid.astype(bool)
    cls = cls.astype(torch.empty((), dtype=out.det.cls.dtype).numpy().dtype)
    ood_np = parts[5] if ood is not None else None
    results = []
    for i in range(n):
        m = valid[i]
        res = dict(boxes=boxes[i][m], conf=conf[i][m], cls=cls[i][m], logits=logits[i][m],
                   num_valid=int(m.sum()))
        if ood_np is not None:
            # _decisions_for_method follows the reference convention
            # 1 = InD / 0 = OoD; serve the OoD verdict directly
            res["is_ood"] = ood_np[i][m] == 0
        results.append(res)
    return results


__all__ = ["MicroBatchServer"]
