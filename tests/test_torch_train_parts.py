"""The training pieces the JAX package holds no counterpart step for, on
the CPU at 64 px: remat against the plain step, yolov10's detached one2one
branch, freeze, resume from a checkpoint, the backbone graft (its count
against the JAX package's), and the native letterbox's first load from
many threads (C4)."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.core.checkpoint import (load_checkpoint, restore_train_state,
                                                           save_checkpoint, state_dict_equal)
from ood_in_object_detection_torch.data import native
from ood_in_object_detection_torch.data.dataset import DetectionDataset, PaddedBatcher
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.models import yolo as Y
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_torch.train.loss import detection_loss
from ood_in_object_detection_torch.utils.weights import graft_classification_backbone
from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.utils import weight_import as JW

IMG, NC = 64, 2
CFG = dict(lr0=0.01, epochs=10, steps_per_epoch=5, warmup_epochs=0.0)


def seeded(name="yolov8n", seed=0):
    m = build_model(name, nc=NC)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(images=rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32),
                gt_labels=np.array([[0, 1], [1, 0]], np.int32),
                gt_bboxes=np.array([[[4, 6, 30, 40], [30, 20, 60, 62]],
                                    [[10, 10, 50, 40], [2, 30, 25, 60]]], np.float32),
                gt_mask=np.ones((2, 2), bool))


def test_remat_train_step_matches_plain():
    """remat changes memory, not math (the JAX package's
    test_remat_train_step_matches_plain bounds): the same loss and
    parameters after a step, and every layer ran under
    torch.utils.checkpoint."""
    a, b = seeded(), seeded()
    calls = []
    real = Y.checkpoint

    def counting(fn, *args, **kw):
        calls.append(type(fn).__name__)
        return real(fn, *args, **kw)

    Y.checkpoint = counting
    try:
        cfg = TTR.TrainConfig(**CFG)
        sa, la = TTR.train_step(a, cfg, TTR.init_state(a, cfg), batch())
        cfg_r = TTR.TrainConfig(**CFG, remat=True)
        sb, lb = TTR.train_step(b, cfg_r, TTR.init_state(b, cfg_r), batch())
    finally:
        Y.checkpoint = real
    assert len(calls) == len(b.model) and calls[-1] == "Detect"
    np.testing.assert_allclose(float(lb.total), float(la.total), rtol=1e-6, atol=1e-7)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    for (n, x), y in zip(a.named_buffers(), b.buffers()):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-6, err_msg=n)


def test_v10_one2one_loss_leaves_backbone_without_gradient():
    """yolov10's one2one pair runs on detached neck features in training
    (the JAX head.py:55): its loss alone sends no gradient into the backbone
    and neck, while the one2many loss does."""
    m = seeded("yolov10n")
    m.train()
    b = TTR.batch_to(batch(), "cpu")
    args = (b["gt_labels"], b["gt_bboxes"], b["gt_mask"], NC)
    one2one, _, one2many = m(b["images"])
    detection_loss(one2one, *args, assign_topk=1).total.backward(retain_graph=True)
    head = f"model.{m.detect_layer_idx}."
    body = {n: p for n, p in m.named_parameters() if not n.startswith(head)}
    assert all(p.grad is None for p in body.values())
    o2o = [p for n, p in m.named_parameters() if n.startswith(head + "one2one_")]
    assert o2o and all(p.grad is not None for p in o2o)
    assert sum(float(p.grad.abs().sum()) for p in o2o) > 0
    detection_loss(one2many, *args).total.backward()
    assert all(p.grad is not None for p in body.values())
    assert sum(float(p.grad.abs().sum()) for p in body.values()) > 0


def test_freeze_keeps_backbone_and_moves_its_statistics():
    m = seeded()
    freeze = TTR.backbone_freeze_prefixes(m.spec)
    assert freeze == tuple(f"model.{i}." for i in range(10))
    cfg = TTR.TrainConfig(**CFG, freeze_prefixes=freeze)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    state = TTR.init_state(m, cfg)
    TTR.train_step(m, cfg, state, batch())
    after = m.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked") or "dfl" in k:
            continue
        frozen = k.startswith(freeze)
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, before[k]), k
        elif frozen:
            assert torch.equal(v, before[k]), k
    assert not any(p in state.optimizer.state for n, p in m.named_parameters()
                   if n.startswith(freeze))
    assert not torch.equal(after["model.22.cv3.0.2.weight"], before["model.22.cv3.0.2.weight"])


def test_restore_train_state_resumes_the_same_run(tmp_path):
    """A checkpoint of a training state restores parameters, statistics,
    EMA, momentum buffers and step: the next step equals the uninterrupted
    run's, bit for bit on the CPU. Weight-only checkpoints still load and
    refuse to resume."""
    cfg = TTR.TrainConfig(**CFG)
    m = seeded()
    state = TTR.init_state(m, cfg)
    for i in range(2):
        TTR.train_step(m, cfg, state, batch(i))
    save_checkpoint(tmp_path / "run", state, {"name": "run", "nc": NC}, "yolov8n", epoch=3)
    m2 = build_model("yolov8n", nc=NC)
    restored, meta = restore_train_state(tmp_path / "run", m2, cfg, None)
    assert meta["epoch"] == 3 and restored.step == 2
    assert state_dict_equal(restored.ema_params, state.ema_params)
    _, la = TTR.train_step(m, cfg, state, batch(5))
    _, lb = TTR.train_step(m2, cfg, restored, batch(5))
    assert float(la.total) == float(lb.total)
    assert state_dict_equal(m.state_dict(), m2.state_dict())
    assert state_dict_equal(restored.ema_params, state.ema_params)
    sd, _ = load_checkpoint(tmp_path / "run")
    assert set(sd) == set(m.state_dict())
    save_checkpoint(tmp_path / "weights", m, {"name": "w"}, "yolov8n")
    with pytest.raises(ValueError, match="cannot resume"):
        restore_train_state(tmp_path / "weights", build_model("yolov8n", nc=NC), cfg)


def test_graft_classification_backbone_matches_jax(tmp_path):
    """A classification checkpoint written here (an ultralytics-style dict
    whose ``model`` is a state_dict: layers 0-8 of another yolov8n and a
    classify head) grafts layers 0-6 alone, and the count equals the JAX
    package's."""
    donor = seeded(seed=5).state_dict()
    cls_sd = {k: v for k, v in donor.items() if int(k.split(".")[1]) <= 8}
    cls_sd["model.9.linear.weight"] = torch.zeros(1000, 1280)
    cls_sd["model.9.linear.bias"] = torch.zeros(1000)
    path = tmp_path / "yolov8n-cls.pt"
    torch.save({"model": cls_sd}, path)

    m = seeded()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    n = graft_classification_backbone(m, str(path))
    for k, v in m.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        layer = int(k.split(".")[1])
        assert torch.equal(v, donor[k] if layer <= 6 else before[k]), k

    jm = jax_build_model("yolov8n", nc=NC)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    v, _ = JW.import_state_dict(shapes, {k: x.numpy() for k, x in before.items()},
                                m.detect_layer_idx, strict=True)
    _, jn = JW.graft_classification_backbone(v, str(path), jm.spec)
    assert n == jn > 0
    with pytest.raises(ValueError, match="no model.0..6"):
        torch.save({"model": {"head.weight": torch.zeros(2)}}, tmp_path / "bad.pt")
        graft_classification_backbone(m, str(tmp_path / "bad.pt"))


def write_images(root, n=12):
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    names = []
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"i{i}.png")
        (root / "labels" / f"i{i}.txt").write_text("0 0.5 0.5 0.4 0.4\n")
        names.append(f"./images/i{i}.png")
    (root / "split.txt").write_text("\n".join(names) + "\n")
    (root / "d.yaml").write_text("path: .\ntrain: split.txt\nval: split.txt\nnames:\n  0: a\n")
    return root / "d.yaml"


def test_native_letterbox_first_load_is_settled_for_every_thread(tmp_path):
    """C4: 16 threads call the loader of a process that has not loaded the
    library yet (the module's state reset, a short switch interval): all get
    the same handle; a first threaded batch equals a second pass bit for
    bit, every image letterboxed by the same path."""
    ds = DetectionDataset.from_yaml(str(write_images(tmp_path)), split="train")
    saved = (native._LIB, native._TRIED, sys.getswitchinterval())
    try:
        sys.setswitchinterval(1e-6)
        for _ in range(3):
            native._LIB, native._TRIED = None, False
            start = threading.Barrier(16)
            got = []

            def call():
                start.wait(timeout=30)
                got.append(native._load())

            threads = [threading.Thread(target=call) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert len(got) == 16 and all(h is got[0] for h in got)
        native._LIB, native._TRIED = None, False
        first = next(iter(PaddedBatcher(ds, 12, 64, workers=8)))["images"].copy()
        second = next(iter(PaddedBatcher(ds, 12, 64, workers=8)))["images"]
        np.testing.assert_array_equal(first, second)
    finally:
        sys.setswitchinterval(saved[2])
        native._LIB, native._TRIED = saved[0], saved[1]
