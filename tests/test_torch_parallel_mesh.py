"""The port's mesh API (``parallel/mesh.py``) and process group
(``parallel/distributed.py``) on the CPU: meshes of repeated 'cpu' entries
stand for cards; on the ``sp`` and ``model`` axes predict and the server
run (parallel/spatial.py), and so do training's uses (one gloo rank per
entry);
``param_spec`` equals the JAX package's on every leaf of
yolov8n; spawned gloo ranks report failures and hangs by rank, each joined
within 120 s at most."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import _two_threads  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks
from ood_in_object_detection_torch.engine import Detector
from ood_in_object_detection_torch.models import build_model
from ood_in_object_detection_torch.parallel import (batch_sharding, device_put_batch, make_mesh,
                                                    make_multislice_mesh, num_slices, param_spec,
                                                    parse_devices, prefetch_to_device,
                                                    replicated, shard_params)
from ood_in_object_detection_torch.parallel.distributed import backend_for, spawn
from ood_in_object_detection_torch.serving import MicroBatchServer
from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.parallel.mesh import param_spec as jax_param_spec
from ood_in_object_detection_tpu.utils.weight_import import export_state_dict

CPU8 = ["cpu"] * 8


def test_mesh_shapes_and_batch_axes():
    """make_mesh(dcn=2, data=4) is 8-way data parallelism: the batch splits
    into 8 equal contiguous shards, dcn-major; the other meshes of the JAX
    test build; one host is one slice."""
    mesh = make_mesh(dcn=2, data=4, devices=CPU8)
    assert dict(mesh.shape) == {"dcn": 2, "data": 4, "sp": 1, "model": 1}
    assert len(mesh.batch_devices) == 8
    assert batch_sharding(mesh).slices(16) == [slice(2 * i, 2 * i + 2) for i in range(8)]
    assert replicated(mesh).slices(16) == [slice(0, 16)]
    assert dict(make_mesh(devices=CPU8).shape) == {"dcn": 1, "data": 8, "sp": 1, "model": 1}
    assert dict(make_mesh(data=4, model=2, devices=CPU8).shape)["model"] == 2
    assert dict(make_mesh(data=2, sp=4, devices=CPU8).shape)["sp"] == 4
    assert num_slices() == 1
    assert dict(make_multislice_mesh(devices=CPU8).shape) == dict(make_mesh(devices=CPU8).shape)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(data=3, devices=CPU8)
    with pytest.raises(ValueError, match="divide"):
        batch_sharding(mesh).slices(12)


def test_mesh_entries_and_missing_cards():
    """--device lists; a card that is missing raises (no CPU fallback)."""
    assert parse_devices("cpu,cpu") == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(devices=["cpu", "cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()
    else:
        with pytest.raises(RuntimeError, match="missing"):
            make_mesh(devices=[torch.cuda.device_count()])
    assert backend_for(["cpu", "cpu"]) == "gloo"
    cards = [torch.device("cuda", i) for i in range(4)]
    assert backend_for(cards) == "nccl"
    assert backend_for([cards[0], cards[0]]) == "gloo"  # NCCL refuses two ranks on one card


@pytest.fixture(scope="module")
def tiny_detector():
    return Detector.create("yolov8n", nc=2, img_size=64, device="cpu")


@pytest.fixture(scope="module")
def training_uses():
    """The four training uses on an sp=2 and a model=2 mesh of two gloo
    ranks (one spawn)."""
    batch = dict(images=np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
                 gt_labels=np.array([[0, 1], [1, 0]], np.int32),
                 gt_bboxes=np.array([[[4, 6, 30, 40], [30, 20, 60, 62]]] * 2, np.float32),
                 gt_mask=np.ones((2, 2), bool))
    images = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    return spawn(ranks.training_uses, ["cpu", "cpu"], args=(batch, images), join_timeout=120,
                 threads=1)


@pytest.mark.parametrize("axes", [dict(sp=2), dict(model=2)])
def test_sp_and_model_axes_raise_a12b(axes, tiny_detector, training_uses):
    """The ``sp`` and ``model`` axes (the name is from when training's uses
    raised): the inference uses run (predict's outputs those of the
    unsharded predict, the server builds), and so do training's four, one
    rank per entry: device_put_batch and
    prefetch_to_device give each rank its batch rows (on sp, its half of
    the height), shard_state and make_sharded_train_step take a step whose
    loss terms are the same on both ranks."""
    mesh = make_mesh(devices=["cpu"] * 4, **axes)
    images = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    got = tiny_detector.predict_sharded(images, mesh, conf_thres=1e-6, pre_nms_k=128)
    want = tiny_detector.predict(images, conf_thres=1e-6, pre_nms_k=128)
    np.testing.assert_array_equal(got.det.valid.numpy(), want.det.valid.numpy())
    np.testing.assert_allclose(got.det.boxes.numpy(), want.det.boxes.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert MicroBatchServer(tiny_detector, batch_size=4, mesh=mesh).mesh is mesh
    a, b = (r[tuple(axes)] for r in training_uses)
    h = 32 if "sp" in axes else 64
    assert a["put"] == (4, h, 64, 3) and a["fed"] == (2, 3, h, 64)
    assert a["loss"] == b["loss"] and np.isfinite(a["loss"]).all() and a["step"] == 1


def test_param_spec_matches_jax_on_every_leaf():
    """The TP rule on yolov8n's parameters at model=2 and 4: JAX's spec of
    each flax leaf, carried to the port's names and layout by
    export_state_dict (a sharded leaf exported as ones), equals the port's
    spec of the same tensor; both shard cout."""
    tm = build_model("yolov8n", nc=2)
    jm = jax_build_model("yolov8n", nc=2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                            train=False))
    sd = dict(tm.state_dict())
    for m in (2, 4):
        marks = jax.tree_util.tree_map_with_path(
            lambda p, x: np.full(x.shape, float(bool(jax_param_spec(p, x, m))), np.float32),
            shapes)
        exported = export_state_dict(marks, detect_layer_idx=tm.detect_layer_idx)
        n_sharded = 0
        for name, mark in exported.items():
            if name not in sd or not sd[name].is_floating_point():
                continue
            spec = param_spec(name, sd[name], m)
            assert bool(spec) == bool(np.all(mark == 1)), (m, name)
            assert spec in ((), ("model", None, None, None))
            n_sharded += bool(spec)
        assert n_sharded > 20
        specs = shard_params(tm, make_mesh(model=m, devices=["cpu"] * 4))
        assert sum(bool(s) for s in specs.values()) == n_sharded
    assert param_spec("w", torch.zeros(128, 64, 3, 3), 1) == ()
    assert param_spec("w", torch.zeros(16, 3, 3, 3), 2) == ()
    assert param_spec("b", torch.zeros(128), 2) == ()


def test_device_put_batch_and_prefetch_keep_the_rows():
    mesh = make_mesh(data=4, devices=["cpu"] * 4)
    batch = {"images": np.arange(8 * 2 * 2 * 3, dtype=np.float32).reshape(8, 2, 2, 3),
             "gt_labels": np.arange(16, dtype=np.int32).reshape(8, 2),
             "im_names": [f"i{k}" for k in range(8)]}
    shards = device_put_batch(batch, mesh)
    assert len(shards) == 4
    np.testing.assert_array_equal(np.concatenate([s["images"].numpy() for s in shards]),
                                  batch["images"])
    assert [s["im_names"] for s in shards][1] == ["i2", "i3"]
    with pytest.raises(ValueError, match="divide"):
        device_put_batch({"images": batch["images"][:6]}, mesh)
    # one process, one device: a one-entry mesh feeds the whole batch in
    # the trainer's layout (prefetching or not); a multi-entry mesh needs
    # one rank per entry
    train = [dict(images=np.full((2, 4, 4, 3), float(i), np.float32),
                  gt_labels=np.zeros((2, 1), np.int32), gt_bboxes=np.zeros((2, 1, 4), np.float32),
                  gt_mask=np.ones((2, 1), bool)) for i in range(3)]
    for size in (0, 2, 7):
        got = list(prefetch_to_device(iter(train), make_mesh(devices=["cpu"]), size=size))
        assert [float(b["images"][0, 0, 0, 0]) for b in got] == [0.0, 1.0, 2.0]
        assert got[0]["images"].shape == (2, 3, 4, 4)
    with pytest.raises(ValueError, match="one rank per"):
        next(prefetch_to_device(iter(train), make_mesh(devices=["cpu"] * 2)))


def test_spawned_ranks_take_their_rows_and_reduce():
    """Under a process group each rank's device_put_batch is its own rows;
    all_reduce_sum coalesces tensors of two dtypes."""
    batch = {"x": np.arange(12, dtype=np.float32).reshape(4, 3)}
    rows = spawn(ranks.reduce_rows, ["cpu", "cpu"], args=(batch,), join_timeout=60, threads=2)
    np.testing.assert_array_equal(rows[1]["x"], batch["x"][2:])
    sums = spawn(ranks.reduce_mixed, ["cpu", "cpu"], join_timeout=60, threads=2)
    for got in sums:
        assert torch.equal(got[0], torch.full((2, 3), 3.0))
        assert torch.equal(got[1], torch.arange(4) * 3) and float(got[2]) == 1.5


def test_spawn_names_the_failed_rank():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 \(cpu\) failed:.*fails on purpose"):
        spawn(ranks.fail_on, ["cpu", "cpu"], args=(1,), join_timeout=60, threads=2)


def test_spawn_names_a_hung_rank():
    """Rank 1 never joins rank 0's collective: the run stops at its join
    timeout, naming the ranks still running, and leaves no process."""
    import multiprocessing

    with pytest.raises(RuntimeError, match=r"did not finish within 10 s"):
        spawn(ranks.hang_on, ["cpu", "cpu"], args=(1,), join_timeout=10, threads=2)
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("rank")]
