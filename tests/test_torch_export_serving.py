"""Serving a bundle on the CPU (the mirror of tests/test_serving.py's bundle
tests and of JAX's bundle contracts): ``MicroBatchServer.from_bundle``, the
SDR refusal and ``cli.ood_eval --export_bundle``. yolov8n at 64 px, nc 2,
BatchNorm calibrated and head spread (tests/test_torch_export.py).

Requests are submitted one at a time, so both servers run the same padded
batch [image, zeros] and a served bundle's rows are held bit for bit against
a live server's (on the CPU a row moves with the batch it is computed in)."""

import json
import pickle

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.cli.factory import build_ood_method
from ood_in_object_detection_torch.ood.methods import (DistanceOODMethod, FusionOODMethod,
                                                       LogitsOODMethod)
from ood_in_object_detection_torch.serving import MicroBatchServer, _BundleModel
from ood_in_object_detection_torch.utils import export as E
from test_torch_export import assert_outputs_equal, spread_detector
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC, CONF = 64, 2, 0.3


def _msp(det=None):
    """MSP fitted on ``det``'s own kept boxes at TPR 0.5, so that its
    thresholds split them (seeded scores without a detector)."""
    m = LogitsOODMethod("MSP")
    if det is None:
        rng = np.random.default_rng(2)
        m.generate_thresholds([rng.uniform(0.2, 1.0, 50) for _ in range(NC)], tpr=0.95)
        return m
    out = det.predict(_images(5, 4), conf_thres=CONF)
    v = out.det.valid
    scores = m.raw_scores(out.logits, out.det.cls)[v].numpy()
    cls = out.det.cls[v].numpy()
    m.generate_thresholds([scores[cls == c] for c in range(NC)], tpr=0.5)
    return m


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    det = spread_detector()
    method = _msp(det)
    p = E.export_serving_bundle(det, method, tmp_path_factory.mktemp("b") / "bundle", batch=2,
                                conf_thres=CONF)
    return det, method, p


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def test_from_bundle_takes_the_bundle_defaults(served):
    _, _, p = served
    srv = MicroBatchServer.from_bundle(p, device="cpu", max_wait_ms=1.0)
    assert (srv.batch_size, srv.conf_thres, srv.max_wait_ms) == (2, CONF, 1.0)
    assert isinstance(srv.ood_method, LogitsOODMethod)
    assert isinstance(srv.detector, _BundleModel)
    assert (srv.detector.img_size, srv.detector.nc) == (IMG, NC)
    assert srv.detector.device == torch.device("cpu")
    assert srv.detector.neck_channels() == (64, 128, 256)


@pytest.mark.parametrize("kw,match", [(dict(batch_size=4), "fixed-shape"),
                                      (dict(conf_thres=0.5), "conf_thres")])
def test_from_bundle_refuses_a_mismatch(served, kw, match):
    """The program is fixed at the bundle's batch and threshold (JAX
    tests/test_serving.py:79-111, 198-204)."""
    with pytest.raises(ValueError, match=match):
        MicroBatchServer.from_bundle(served[2], device="cpu", **kw)


def test_from_bundle_serves_the_live_servers_results(served):
    """uint8 submits to a bundle server and to a live server of the same
    weights and method: equal rows, verdicts included; the warm-up ran the
    bundle's step."""
    det, method, p = served
    imgs = _images(7, 3)
    bundle_srv = MicroBatchServer.from_bundle(p, device="cpu", max_wait_ms=1.0)
    calls = []
    real = bundle_srv.detector._call
    bundle_srv.detector._call = lambda x: calls.append(x.shape) or real(x)
    with bundle_srv:
        assert calls == [(2, IMG, IMG, 3)], "start() warms up on the bundle's step"
        got = [bundle_srv.predict_one(im) for im in imgs]
    with MicroBatchServer(det, batch_size=2, max_wait_ms=1.0, conf_thres=CONF,
                          ood_method=method) as srv:
        want = [srv.predict_one(im) for im in imgs]
    assert sum(r["num_valid"] for r in got) > 5
    assert any(r["is_ood"].any() for r in got) and any((~r["is_ood"]).any() for r in got)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_bundle_model_normalises_uint8_as_the_detector(served):
    """_BundleModel.predict on uint8 and on the same images divided on the
    host as Detector.predict divides them: equal outputs."""
    det, _, p = served
    call, _, meta = E.load_serving_bundle(p, device="cpu")
    model = _BundleModel(call, meta, "cpu")
    imgs = _images(3, 2)
    assert_outputs_equal(model.predict(imgs), det.predict(imgs, conf_thres=CONF))
    f32 = torch.from_numpy(imgs).float() * torch.tensor(1.0 / 255.0)
    assert_outputs_equal(model.predict(f32.numpy()), model.predict(imgs))


def _sdr_like():
    m = DistanceOODMethod.from_name("L2_cl_stride")
    m.transform_fn = lambda state, acts, c, s: acts  # stands for a fitted SDR embedding
    return m


@pytest.mark.parametrize("make", [
    _sdr_like,
    lambda: FusionOODMethod([_msp(), _sdr_like()], strategy="or"),
    lambda: build_ood_method("CosineIvis", device="cpu"),
], ids=["transform_fn", "fusion_member", "CosineIvis"])
def test_bundle_refuses_sdr(served, make, tmp_path):
    """JAX tests/test_export_viz.py:140-147: a method with a fitted SDR
    embedding is refused, naming the bundle, before anything is written."""
    det = served[0]
    with pytest.raises(ValueError, match="bundle"):
        E.export_serving_bundle(det, make(), tmp_path / "b2")
    assert not (tmp_path / "b2").exists()


def _write_dataset(root, det, name, images, conf):
    """Images and YOLO labels from ``det``'s own detections above ``conf``,
    plus a dataset yaml (the same recipe as tests/test_torch_pipeline.py)."""
    from PIL import Image

    (root / name / "images").mkdir(parents=True)
    (root / name / "labels").mkdir()
    out = det.predict(images, conf_thres=conf)
    for i, img in enumerate(images):
        f = root / name / "images" / f"{name}{i}.png"
        Image.fromarray(img).save(f)
        v = out.det.valid[i]
        lines = [f"{int(c)} {(x1 + x2) / 2 / IMG:.6f} {(y1 + y2) / 2 / IMG:.6f} "
                 f"{(x2 - x1) / IMG:.6f} {(y2 - y1) / IMG:.6f}"
                 for (x1, y1, x2, y2), c in zip(out.det.boxes[i][v].tolist(),
                                                out.det.cls[i][v].tolist())]
        (root / name / "labels" / f"{name}{i}.txt").write_text("\n".join(lines) + "\n")
    (root / f"{name}.txt").write_text("\n".join(
        f"./{name}/images/{name}{i}.png" for i in range(len(images))))
    (root / f"{name}.yaml").write_text(
        f"path: .\ntrain: {name}.txt\nval: {name}.txt\nnames:\n  0: c0\n  1: c1\n")


def test_cli_export_bundle_writes_a_loadable_bundle(tmp_path, monkeypatch):
    """cli.ood_eval --model_path ... --export_bundle DIR --export_bundle_batch 2
    after the InD configuration: DIR loads with no model code, its method
    holds the CLI's fitted thresholds and its program predicts as the
    checkpoint's detector."""
    from ood_in_object_detection_torch import constants as C
    from ood_in_object_detection_torch.cli import ood_eval
    from ood_in_object_detection_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from ood_in_object_detection_torch.engine import Detector

    det = spread_detector()
    images = _images(11, 8)
    _write_dataset(tmp_path, det, "ind", images[:4], 0.3)
    _write_dataset(tmp_path, det, "ood", images[4:], 0.3)
    save_checkpoint(tmp_path / "run", det.model, {"name": "run"}, "yolov8n")
    monkeypatch.setattr(C, "RESULTS_PATH", tmp_path / "results")
    monkeypatch.setattr(C, "STORAGE_PATH", tmp_path / "storage")
    bundle = tmp_path / "bundle"
    ood_eval.main(["--ood_method", "MSP", "--model_path", str(tmp_path / "run"),
                   "--device", "cpu", "--img_size", str(IMG), "--batch_size", "4",
                   "--ind_dataset", str(tmp_path / "ind.yaml"),
                   "--ood_datasets", str(tmp_path / "ood.yaml"),
                   "--conf_thr_train", "0.3", "--conf_thr_test", "0.35",
                   "--export_bundle", str(bundle), "--export_bundle_batch", "2"])
    meta = json.loads((bundle / "bundle.json").read_text())
    assert (meta["batch"], meta["conf_thres"], meta["nc"]) == (2, 0.35, NC)
    call, method, meta = E.load_serving_bundle(bundle, device="cpu")
    (thr,) = (tmp_path / "storage").glob("*_thresholds.pkl")
    assert [method.thresholds] == pickle.loads(thr.read_bytes())
    assert any(t is not None for t in method.thresholds)
    sd, ckpt_meta = load_checkpoint(tmp_path / "run")
    live = Detector.create(ckpt_meta["model_name"], nc=ckpt_meta["nc"], img_size=IMG,
                           device="cpu", state_dict=sd)
    x = images[4:6]
    out = call(torch.from_numpy(x).float() * torch.tensor(1.0 / 255.0))
    assert_outputs_equal(out, live.predict(x, conf_thres=0.35))


def test_serve_bundle_script(served, tmp_path):
    """scripts/serve_bundle.py on the CPU: every request answered, each
    result the bundle's own row of its recorded group, the report's
    numbers in place."""
    from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method
    from ood_in_object_detection_torch.scripts import serve_bundle
    from ood_in_object_detection_torch.serving import _split_output

    det, method, p = served
    imgs = _images(13, 6)
    np.save(tmp_path / "req.npy", imgs)
    report = serve_bundle.main(["--bundle", str(p), "--images", str(tmp_path / "req.npy"),
                                "--out", str(tmp_path / "served.pkl"), "--clients", "3",
                                "--device", "cpu"])
    assert (report["requests"], report["unanswered"], report["failed"]) == (6, 0, [])
    assert report["images_per_s"] > 0 and report["latency_ms"]["p99"] > 0
    assert report["launches"] == dict.fromkeys(serve_bundle.COUNTERS, 0)  # plain versions
    served_ = pickle.loads((tmp_path / "served.pkl").read_bytes())
    assert sorted(k for g in served_["groups"] for k in g) == list(range(6))
    model = MicroBatchServer.from_bundle(p, device="cpu").detector
    for rows in served_["groups"]:
        batch = np.zeros((2, IMG, IMG, 3), np.uint8)
        batch[:len(rows)] = imgs[rows]
        out = model.predict(batch)
        want = _split_output(out, len(rows), _decisions_for_method(method, out, (64, 128, 256)))
        for k, w in zip(rows, want):
            for key in w:
                np.testing.assert_array_equal(served_["results"][k][key], w[key], err_msg=key)
