"""Spatial parallelism on the CPU (``parallel/spatial.py``, the ``sp`` rules
of ``models/layers.py``, ``Detector.predict_sharded`` and
``MicroBatchServer(mesh=)`` over an ``sp`` axis): every rule against the
unsharded op, the stem on slabs, every family against its unsharded
predict, a failing shard, a height that does not split, the launch
counters under threads. Torch only; the JAX package's ``sp`` predict is
held in test_torch_parallel_sp.py.

Tolerance: on the CPU a conv over a slab may sum in another order than
over the whole map (oneDNN blocks by height; PyTorch's own convolutions
too, for some shapes). A single op is held within rtol 1e-5 and atol 1e-5
of its largest magnitude. Through a whole detector the difference grows:
yolov8n at 128 px over 4 shards reads 3.2e-5 of the P5 neck map's largest
magnitude and 7.9e-3 px on a box (the DFL decode of a head spread 2.0),
and bit for bit with oneDNN off; yolov10n without oneDNN 5.3e-6 and 2.6e-3
px. So a predict is held with its integer outputs equal, boxes within 1e-2
px, confidences, maps and taps within rtol 1e-4 (maps and taps atol 1e-4
of their largest magnitude: the port-vs-JAX tolerances of
test_torch_parallel_predict). The detectors are
BatchNorm-calibrated and head-spread (utils/weights.py) so that their
detections are not tie-degenerate."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.models import layers as L
from ood_in_object_detection_torch.ops import stem as S
from ood_in_object_detection_torch.ops.kernels import _build
from ood_in_object_detection_torch.parallel import make_mesh, spatial
from ood_in_object_detection_torch.serving import MicroBatchServer
from ood_in_object_detection_torch.utils.weights import (calibrate_batchnorm, load_jax_variables,
                                                         numpy_state_dict, spread_detect_head)

REL = 1e-5
INTS = ("valid", "cls", "anchor_idx")


def close(got, want):
    torch.testing.assert_close(got, want, rtol=REL, atol=REL * float(want.abs().max()))


def sharded(op, x, sp, heights=None):
    """``op`` on ``sp`` row slabs of ``x`` (NCHW), one thread a shard, the
    outputs' rows concatenated."""
    heights = heights or [x.shape[2] // sp] * sp
    bounds = np.cumsum([0] + heights)
    parts = [x[:, :, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    (outs,) = spatial.run([(spatial.SpGroup(["cpu"] * sp), op, parts, [0] * sp)], timeout=60)
    return torch.cat(outs, dim=2)


def seeded(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.rand(p.shape, generator=g) - 0.5)
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return module.eval()


def image(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# -- the rules of models/layers.py, op by op ---------------------------------

@pytest.mark.parametrize("sp,h", [(2, 16), (4, 16), (4, 8)])  # (4, 8): 2 rows a shard
@pytest.mark.parametrize("k,s,groups", [(1, 1, 1), (3, 1, 1), (3, 2, 1), (5, 1, 1),
                                        (5, 2, 1), (7, 1, 1), (7, 2, 1), (3, 2, 8), (7, 1, 8)])
def test_conv_rule_matches_unsharded(sp, h, k, s, groups):
    """Conv (zeros past the image); k 5 and 7 on 2 rows a shard take their
    halo from shards further away; groups 8 is depthwise."""
    conv = seeded(L.Conv(8, 8, k, s, g=groups))
    x = image((2, 8, h, 12))
    with torch.no_grad():
        close(sharded(conv, x, sp), conv(x))


@pytest.mark.parametrize("k,s,sp,h", [(3, 2, 2, 8), (3, 2, 4, 8), (5, 1, 2, 8), (5, 1, 4, 8),
                                      (5, 1, 4, 4)])  # (4, 4): 1 row a shard
def test_max_pool_rule_matches_unsharded(k, s, sp, h):
    """max_pool (-inf past the image): ADown's k 3 s 2, SPPF's and
    SPPELAN's k 5, whose halo of 2 spans two shards of 1 row."""
    x = image((2, 4, h, 6)) - 3.0  # below zero, so a zero fill would show
    close(sharded(lambda t: L.max_pool(t, k, s), x, sp), L.max_pool(x, k, s))


@pytest.mark.parametrize("sp,h", [(2, 8), (4, 8), (2, 4)])  # 2 rows a shard: the last
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])  # keeps 1 of the pool
def test_avg_pool2_rule_and_adown(sp, h, dtype):
    """avg_pool2 (VALID: H - 1 rows, the last shard one short) alone and
    in ADown, whose max-pool and conv then read that short map, and AConv."""
    x = image((2, 8, h, 6)).to(dtype)
    torch.testing.assert_close(sharded(L.avg_pool2, x, sp), L.avg_pool2(x), rtol=0, atol=0)
    with torch.no_grad():
        for block in (seeded(L.ADown(8, 8)), seeded(L.AConv(8, 8))):
            close(sharded(block, x.float(), sp), block(x.float()))


@pytest.mark.parametrize("sp", [2, 4])
def test_resizes_stay_local(sp):
    """Upsample and CBFuse's nearest resize need no halo on aligned rows;
    a resize whose rows do not line up raises (A12c)."""
    x = image((1, 4, 8, 6))
    torch.testing.assert_close(sharded(L.Upsample(), x, sp), L.Upsample()(x), rtol=0, atol=0)
    src, acc = image((1, 4, 4, 3), 2), image((1, 4, 16, 12), 3)
    fuse = L.CBFuse([0])

    def op(bounds):
        def fused(a):
            r = spatial.current().rank
            return fuse([[src[:, :, bounds[r]:bounds[r + 1]]], a])
        return fused

    even = [4 * r // sp for r in range(sp + 1)]
    torch.testing.assert_close(sharded(op(even), acc, sp), fuse([[src], acc]), rtol=0, atol=0)
    with pytest.raises(spatial.ShardFailed, match="not row-local"):
        sharded(op([0, 3] + even[2:] if sp == 4 else [0, 1, 4]), acc, sp)


@pytest.mark.parametrize("sp", [2, 4])
def test_attention_blocks_run_on_the_gathered_map(sp):
    """PSABlock's and ABlock's attention read every row: each shard gathers
    the block's input, runs it whole (the 3x3 and 7x7 positional convs
    without halos) and keeps its rows."""
    x = image((2, 64, 8, 4))
    with torch.no_grad():
        for block in (seeded(L.PSABlock(64, 0.5, 2)), seeded(L.ABlock(64, 2, 1.2, area=4))):
            close(sharded(block, x, sp), block(x))


def test_halo_and_gather_collectives():
    """window() and gather() against slices of the whole map, on unequal
    row counts; rows past the image take the fill."""
    x = image((1, 2, 7, 3))
    heights = [2, 1, 4]

    def op(t):
        shard = spatial.current()
        whole, rows = shard.gather(t)
        torch.testing.assert_close(whole, x)
        torch.testing.assert_close(whole[:, :, rows], t)
        return shard.window(t, 5, 1, 2, fill=-1.0)  # rows [a - 2, b + 2)

    got = spatial.run([(spatial.SpGroup(["cpu"] * 3), op,
                        [x[:, :, :2], x[:, :, 2:3], x[:, :, 3:]], [0] * 3)], timeout=60)[0]
    padded = torch.cat([torch.full((1, 2, 2, 3), -1.0), x, torch.full((1, 2, 2, 3), -1.0)], 2)
    start = 0
    for h, out in zip(heights, got):
        torch.testing.assert_close(out, padded[:, :, start:start + h + 4])
        start += h


@pytest.mark.parametrize("sp", [2, 4])
def test_stem_on_slabs(sp):
    """The fused stem on each shard's slab, [a - 4, b) for every shard but
    the first, its first output row dropped: the unsharded stem's rows."""
    conv0, conv1 = seeded(L.Conv(3, 16, 3, 2)), seeded(L.Conv(16, 32, 3, 2), 1)
    w1, bn1, w2, bn2 = S.stem_conv_params(conv0, conv1)
    x = image((2, 3, 64, 24))
    h = 64 // sp
    with torch.no_grad():
        whole = S.fused_stem_plain(x, w1, bn1, w2, bn2)
        for r in range(sp):
            lo = max(0, r * h - spatial.STEM_OVERLAP)
            out = S.fused_stem_plain(x[:, :, lo:(r + 1) * h], w1, bn1, w2, bn2)
            close(out[:, :, (r * h - lo) // 4:], whole[:, :, r * h // 4:(r + 1) * h // 4])


# -- the detectors ----------------------------------------------------------

def calibrated(name, img, seed=0):
    det = Detector.create(name, nc=2, img_size=img, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    calib = np.random.default_rng(seed).integers(0, 256, (4, img, img, 3), dtype=np.uint8)
    calibrate_batchnorm(det.model, torch.from_numpy(calib).float().permute(0, 3, 1, 2) / 255)
    load_jax_variables(det.model, spread_detect_head(numpy_state_dict(det.model), seed=seed + 1))
    return det


def assert_same(got, want):
    for f in INTS:
        torch.testing.assert_close(getattr(got.det, f), getattr(want.det, f), rtol=0, atol=0)
    torch.testing.assert_close(got.stride_level, want.stride_level, rtol=0, atol=0)
    torch.testing.assert_close(got.det.boxes, want.det.boxes, rtol=0, atol=1e-2)
    torch.testing.assert_close(got.det.conf, want.det.conf, rtol=1e-4, atol=1e-6)
    for a, b in [(got.roi_feats, want.roi_feats), (got.exact_feats, want.exact_feats),
                 *zip(got.neck, want.neck)]:
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("name,img,sp", [("yolov8n", 64, 2), ("yolov9t", 64, 2),
                                         ("yolov10n", 64, 2), ("yolo11n", 64, 2),
                                         ("yolo12n", 64, 2), ("yolov8n", 128, 4)])
def test_family_sp_predict_matches_unsharded(name, img, sp):
    """Every family's predict over an ``sp`` axis (batch 2 over data 1, and
    over data 2 x sp), outputs gathered on the first entry, against the
    unsharded predict: convs, pools, ADown / AConv, SCDown, PSA, C2PSA,
    A2C2f's area attention and the v10 head on slabs."""
    det = calibrated(name, img)
    images = np.random.default_rng(5).integers(0, 256, (4, img, img, 3), dtype=np.uint8)
    want = det.predict(images, conf_thres=0.25)
    assert int(want.det.valid.sum()) > 20
    for data in (1, 2):
        got = det.predict_sharded(images, make_mesh(data=data, sp=sp,
                                                    devices=["cpu"] * (data * sp)),
                                  conf_thres=0.25)
        assert_same(got, want)
        stats = det.last_sp_stats
        assert len(stats) == data and all(len(g) == sp for g in stats)
        assert all(s.exchanges > 0 and s.halo_rows > 0 for g in stats for s in g)


@pytest.fixture(scope="module")
def v8n():
    return calibrated("yolov8n", 64)


def test_conv_stem_route_over_sp(v8n):
    """The stem as two Conv modules (``folded_stem`` off, yolov9e's route):
    each shard drops the image rows it holds above its own and the stem's
    convs exchange halos instead."""
    images = np.random.default_rng(6).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    v8n.model.folded_stem = False
    try:
        want = v8n.predict(images, conf_thres=0.25)
        got = v8n.predict_sharded(images, make_mesh(sp=2, devices=["cpu"] * 2), conf_thres=0.25)
    finally:
        v8n.model.folded_stem = True
    assert v8n.model.stem_route == "fused" and int(want.det.valid.sum()) > 20
    assert_same(got, want)


def test_height_that_does_not_split_raises(v8n):
    images = np.zeros((2, 96, 96, 3), np.uint8)
    with pytest.raises(ValueError, match="height of 96.*sp=2.*multiple of 64"):
        v8n.predict_sharded(images, make_mesh(sp=2, devices=["cpu"] * 2))


def test_a_failing_shard_raises_naming_it(v8n, monkeypatch):
    """A shard that raises breaks its group's barrier: the others stop and
    the call raises, naming the shard, well within 30 s."""
    forward = L.C2f.forward

    def flaky(self, x):
        shard = spatial.current()
        if shard is not None and shard.rank == 1:
            raise RuntimeError("injected fault")
        return forward(self, x)

    monkeypatch.setattr(L.C2f, "forward", flaky)
    images = np.zeros((2, 64, 64, 3), np.uint8)
    t0 = time.monotonic()
    with pytest.raises(spatial.ShardFailed, match="sp shard 1 of 2 on cpu failed: "
                                                  "RuntimeError: injected fault"):
        v8n.predict_sharded(images, make_mesh(sp=2, devices=["cpu"] * 2))
    assert time.monotonic() - t0 < 30
    monkeypatch.undo()  # the same threads serve the next call
    got = v8n.predict_sharded(images, make_mesh(sp=2, devices=["cpu"] * 2))
    assert got.det.valid.shape == (2, 300)


def test_launch_counters_exact_under_threads():
    """count_launch from 8 threads under a short switch interval: no lost
    update, in the total or per card index."""
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_device = __import__("collections").Counter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper, device=0)
                                                    for _ in range(5000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 40000 and wrapper.launches_by_device[0] == 40000


def test_server_over_sp_equals_direct_predict(v8n):
    """MicroBatchServer(mesh=sp 2): each request's row of the group equals
    the direct predict of the group as the server stacked it."""
    images = np.random.default_rng(8).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    direct = v8n.predict(images, conf_thres=0.25)
    with MicroBatchServer(v8n, batch_size=4, max_wait_ms=2000, conf_thres=0.25,
                          mesh=make_mesh(sp=2, devices=["cpu"] * 2)) as srv:
        futs = [srv.submit(im) for im in images]
        results = [f.result(timeout=120) for f in futs]
    for i, res in enumerate(results):
        n = int(direct.det.valid[i].sum())
        assert res["num_valid"] == n > 0
        np.testing.assert_array_equal(res["cls"], direct.det.cls[i, :n].numpy())
        np.testing.assert_allclose(res["boxes"], direct.det.boxes[i, :n].numpy(), rtol=REL,
                                   atol=REL * 64)
