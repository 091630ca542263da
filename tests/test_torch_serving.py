"""MicroBatchServer (serving.py) on the CPU: coalesced serving gives the
port's direct batched predict (the mirror of tests/test_serving.py; its
two bundle tests are mirrored in tests/test_torch_export_bundle.py); and
the tools beside it,
utils/profiling.py and utils/consistency.py.

The detector is a seeded yolov8n at 64 px, its BatchNorm calibrated and its
head spread (utils/weights.py), so that detections are not tie-degenerate.
Served results are held against a direct predict of the group as the
server stacked it (the rows in the order the requests arrived, zeros after):
the CPU's convolutions sum in another order for another batch or another
order of its rows, which moves boxes by up to ~1e-3 px, so a row is held
exactly only against the same batch."""

import sys
import threading

import numpy as np
import pytest
import torch

from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.ood.methods import DistanceOODMethod, LogitsOODMethod
from ood_in_object_detection_torch.ood.pipeline import _decisions_for_method
from ood_in_object_detection_torch.serving import MicroBatchServer
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)
from torch_threads import _two_threads  # noqa: F401 (autouse)

IMG, NC, CONF = 64, 4, 0.25


@pytest.fixture(scope="module")
def det():
    d = Detector.create("yolov8n", nc=NC, img_size=IMG, device="cpu")
    calib = np.random.default_rng(9).integers(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    calibrate_batchnorm(d.model, torch.from_numpy(calib).float().permute(0, 3, 1, 2) / 255)
    load_jax_variables(d.model, spread_detect_head(numpy_state_dict(d.model), seed=1))
    return d


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def _submit_concurrently(srv, imgs):
    futs = [None] * len(imgs)

    def put(i):
        futs[i] = srv.submit(imgs[i])

    threads = [threading.Thread(target=put, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return futs


def _recording(srv):
    """Wrap the server's predict step to keep every batch it stacks."""
    batches, real = [], srv._predict
    srv._predict = lambda images: batches.append(np.array(images)) or real(images)
    return batches


def _row_of(batch, img):
    (rows,) = np.nonzero((batch == img[None]).reshape(len(batch), -1).all(1))
    return int(rows[0])


def _assert_row(res, direct, i, box_atol=0.0):
    v = direct.det.valid[i].numpy()
    assert res["num_valid"] == int(v.sum())
    np.testing.assert_allclose(res["boxes"], direct.det.boxes[i].numpy()[v], rtol=0,
                               atol=box_atol)
    np.testing.assert_array_equal(res["cls"], direct.det.cls[i].numpy()[v])
    np.testing.assert_allclose(res["conf"], direct.det.conf[i].numpy()[v], rtol=0, atol=1e-6)
    assert res["logits"].shape == (res["num_valid"], NC)


def test_serving_matches_direct_predict(det):
    """Four concurrent requests coalesce into one group; a fifth lone
    request pads a partial group."""
    imgs = _images(0, 5)
    with MicroBatchServer(det, batch_size=4, max_wait_ms=200.0, conf_thres=CONF) as srv:
        batches = _recording(srv)
        results = [f.result(timeout=120) for f in _submit_concurrently(srv, imgs[:4])]
        lone = srv.predict_one(imgs[4])
    group, padded = batches
    assert sum(r["num_valid"] for r in results) > 4 and not padded[1:].any()
    direct = det.predict(group, conf_thres=CONF)
    for i, res in enumerate(results):
        _assert_row(res, direct, _row_of(group, imgs[i]))
    _assert_row(lone, det.predict(padded, conf_thres=CONF), 0)


def test_serving_start_warms_up_one_full_batch(det, monkeypatch):
    """start() returns after one full-batch uint8 step in the collector
    thread, the thread that serves (its own library handles warmed)."""
    seen = []
    srv = MicroBatchServer(det, batch_size=3, conf_thres=CONF)
    real = srv._predict
    monkeypatch.setattr(srv, "_predict", lambda x: seen.append(
        (x.shape, x.dtype, threading.current_thread())) or real(x))
    srv.start()
    thread = srv._thread
    assert seen == [((3, IMG, IMG, 3), np.uint8, thread)]
    srv.stop()


def test_serving_start_raises_when_warm_up_fails(det, monkeypatch):
    """A warm-up step that raises makes start() raise; the server is not
    running."""
    srv = MicroBatchServer(det, batch_size=2, conf_thres=CONF)

    def broken(images):
        raise RuntimeError("the warm-up step failed")

    monkeypatch.setattr(srv, "_predict", broken)
    with pytest.raises(RuntimeError, match="warm-up step failed"):
        srv.start()
    assert srv._thread is None
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit(np.zeros((IMG, IMG, 3), np.uint8))


def test_serving_with_fitted_ood_method(det):
    """A fitted method attached to the server gives per-box is_ood verdicts
    equal to the pipeline's decisions (1 = InD inverted to an OoD flag):
    MSP, and Cosine_cl_stride on seeded centroids (the distance path)."""
    rng = np.random.default_rng(2)
    msp = LogitsOODMethod(name="MSP")
    msp.generate_thresholds([rng.uniform(0.2, 1.0, 50).astype(np.float32) for _ in range(NC)],
                            tpr=0.95)
    cos = DistanceOODMethod.from_name("Cosine_cl_stride")
    widths = det.neck_channels()
    cos.clusters = [[rng.normal(size=(2, c)).astype(np.float32) for c in widths]
                    for _ in range(NC)]
    cos.thresholds = [[0.9, 0.9, 0.9] for _ in range(NC)]
    imgs = _images(3, 2)
    padded = np.concatenate([imgs[:1], np.zeros_like(imgs[:1])])
    direct = det.predict(padded, conf_thres=CONF)
    for method in (msp, cos):
        want = _decisions_for_method(method, direct, widths).numpy()
        with MicroBatchServer(det, batch_size=2, max_wait_ms=1.0, conf_thres=CONF,
                              ood_method=method) as srv:
            res = srv.predict_one(imgs[0])
        _assert_row(res, direct, 0)
        v = direct.det.valid[0].numpy()
        np.testing.assert_array_equal(res["is_ood"], want[0][v] == 0)
        assert res["is_ood"].dtype == bool and len(res["is_ood"]) == res["num_valid"] > 0


def test_serving_error_propagates_and_keeps_serving(det):
    with MicroBatchServer(det, batch_size=2, max_wait_ms=1.0, conf_thres=CONF) as srv:
        bad = srv.submit(np.zeros((7, 7, 3), np.float32))  # wrong size
        with pytest.raises(Exception):
            bad.result(timeout=120)
        ok = srv.predict_one(_images(1, 1)[0])
        assert ok["num_valid"] >= 0


def test_serving_raise_mid_batch_fails_all_futures(det):
    """A predict step that raises while a group is in flight fails every
    future of the group, and the server keeps serving."""
    imgs = _images(5, 2)
    with MicroBatchServer(det, batch_size=2, max_wait_ms=200.0, conf_thres=CONF) as srv:
        real = srv._predict

        def poisoned(images):
            raise RuntimeError("the step died mid-batch")

        srv._predict = poisoned
        for f in _submit_concurrently(srv, imgs):
            with pytest.raises(RuntimeError, match="mid-batch"):
                f.result(timeout=120)
        srv._predict = real
        ok = srv.predict_one(imgs[0])
        assert ok["num_valid"] >= 0 and ok["boxes"].shape[1] == 4


def test_serving_mixed_dtype_group(det):
    """A group mixing uint8 and float32 images normalizes the uint8 ones on
    the host (np.stack would promote 0-255 into the float batch)."""
    u8 = _images(7, 1)[0]
    f32 = u8.astype(np.float32) / 255.0
    direct = det.predict(f32[None].repeat(2, axis=0), conf_thres=CONF)
    with MicroBatchServer(det, batch_size=2, max_wait_ms=200.0, conf_thres=CONF) as srv:
        batches = _recording(srv)
        res_u8, res_f32 = [f.result(timeout=120) for f in _submit_concurrently(srv, [u8, f32])]
    assert len(batches) == 1 and batches[0].dtype == np.float32
    np.testing.assert_array_equal(batches[0], f32[None].repeat(2, axis=0))
    for res in (res_u8, res_f32):
        _assert_row(res, direct, 0)


def test_serving_submit_after_stop_raises(det):
    srv = MicroBatchServer(det, batch_size=2, max_wait_ms=1.0, conf_thres=CONF).start()
    srv.stop()
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit(np.zeros((IMG, IMG, 3), np.float32))
    srv.stop()  # idempotent


def test_serving_unported_paths_raise(det):
    """A mesh's sp axis serves (parallel/spatial.py), unless the detector's
    image height does not split over it; a bundle never serves over a mesh
    (the JAX ValueError, raised before the bundle is read)."""
    from ood_in_object_detection_torch.parallel import make_mesh

    mesh = make_mesh(sp=2, devices=["cpu"] * 2)
    assert MicroBatchServer(det, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="height of 64"):
        MicroBatchServer(det, mesh=make_mesh(sp=4, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="mesh"):
        MicroBatchServer.from_bundle("bundle_dir", mesh=object())


def test_serving_stress_many_threads(det):
    """16 client threads (more than the cores) submit 4 requests each under a
    short switch interval: every future resolves, each result is its own
    image's row of the direct predict (groups hold the images in any order
    and number, so boxes within 1e-2 px: another image's are pixels away)."""
    imgs = _images(11, 4)
    direct = det.predict(imgs, conf_thres=CONF)
    got = {}
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with MicroBatchServer(det, batch_size=4, max_wait_ms=2.0, conf_thres=CONF) as srv:
            def client(c):
                futs = [(k, srv.submit(imgs[k])) for k in ((c + r) % 4 for r in range(4))]
                res = [(k, f.result(timeout=120)) for k, f in futs]
                with lock:
                    got[c] = res

            threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(got) == list(range(16))
    for res in got.values():
        for k, r in res:
            _assert_row(r, direct, k, box_atol=1e-2)


def test_profiling_time_fn_flops_and_trace(det, tmp_path):
    """utils/profiling.py on the CPU: host-clock times with every output
    consumed, the flop counter's count (4x at 4x the batch), a Chrome trace."""
    from ood_in_object_detection_torch.utils import profiling

    imgs = _images(13, 2)
    t = profiling.time_fn(lambda: det.predict(imgs, conf_thres=CONF), iters=3, warmup=1)
    assert t["device"] == "cpu" and 0 < t["min_ms"] <= t["mean_ms"] <= t["max_ms"]
    assert t["pipelined_ms"] > 0
    one = profiling.flops_estimate(lambda: det.model(torch.zeros(1, 3, IMG, IMG)))
    four = profiling.flops_estimate(lambda: det.model(torch.zeros(4, 3, IMG, IMG)))
    assert one > 1e7 and four == 4 * one
    with profiling.trace(str(tmp_path / "tr")):
        det.predict(imgs, conf_thres=CONF)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_consistency_compare_and_outputs():
    """utils/consistency.py: the bf16 path's pre-NMS taps (raw maps, neck
    maps, RoI and exact taps on fixed boxes) are deterministic on the CPU,
    compare() flags a tap off by more than REL_TOL of its scale, and the
    check refuses to run without a card."""
    from ood_in_object_detection_torch.utils import consistency as K

    model = K.build_model("yolov8n")
    a = K.compute_outputs(model, "cpu", img=64)
    b = K.compute_outputs(model, "cpu", img=64)
    assert sorted(a) == ["exact_feats", "neck0", "neck1", "neck2", "raw0", "raw1", "raw2",
                         "roi_feats"]
    assert a["roi_feats"].shape == (2, 32, 256) and K.compare(a, b) == []
    bad = dict(b, raw0=b["raw0"] * (1 + 2 * K.REL_TOL))
    assert [k for k, _ in K.compare(a, bad)] == ["raw0"]
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        K.check_vs_cpu()
