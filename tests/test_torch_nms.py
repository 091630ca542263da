"""Port parity for NMS and the lazy detect path (ops/nms.py, kernel K1's
plain version; ops/fused_detect.py) against the JAX package, on the CPU.

Keep masks must be equal bit for bit: both sides compute the same f32 IoU
in the same operation order. Decoded boxes, confidences and logits are
compared within 1e-5 relative; boxes also get atol 2e-3 px, because the
DFL expectation (up to 15 grid units) sums its 16 terms in another order,
and a few f32 ulp of it times a stride of 32 reach 1e-3 px."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ood_in_object_detection_tpu.ops import nms as jnms
from ood_in_object_detection_tpu.ops.pallas import nms as jpnms
from ood_in_object_detection_torch.models.head import decode_detections
from ood_in_object_detection_torch.ops import fused_detect as tfd
from ood_in_object_detection_torch.ops import nms as tnms
from ood_in_object_detection_torch.ops.boxes import box_iou
from torch_threads import _two_threads  # noqa: F401 (autouse)

# ops/__init__.py re-exports the function under the module's name
jfd = importlib.import_module("ood_in_object_detection_tpu.ops.fused_detect")
IOU = 0.7


def _controlled_boxes(rng, b, k, ncls=3):
    """Score-sorted, class-offset boxes, and a validity mask: jittered copies
    of k/4 seed boxes, so that suppression chains are common."""
    seed_c = rng.uniform(20, 600, (b, k // 4 + 1, 2))
    seed_wh = rng.uniform(20, 120, (b, k // 4 + 1, 2))
    pick = rng.integers(0, k // 4 + 1, (b, k))
    c = np.take_along_axis(seed_c, pick[..., None], 1) + rng.normal(0, 4, (b, k, 2))
    wh = np.take_along_axis(seed_wh, pick[..., None], 1) * rng.uniform(0.8, 1.2, (b, k, 2))
    cls = rng.integers(0, ncls, (b, k))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + (cls * tnms.MAX_WH)[..., None]
    valid = rng.uniform(size=(b, k)) > 0.1
    return boxes.astype(np.float32), valid


def _assert_iou_margin(boxes, margin=1e-4):
    """No pair sits within `margin` of the threshold, so keep sets cannot
    hinge on the last bit of a float."""
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    near = np.abs(iou - IOU) < margin
    assert not near.any(), f"{near.sum()} pairs within {margin} of iou {IOU}"


@pytest.mark.parametrize("k", [189, 512, 1024])
def test_keep_matches_tiled_and_pallas(k, monkeypatch):
    rng = np.random.default_rng(k)
    boxes, valid = _controlled_boxes(rng, 1, k)
    _assert_iou_margin(boxes[0])
    got = tnms.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), IOU)[0].numpy()
    tiled = np.asarray(jnms._greedy_keep_tiled(jnp.asarray(boxes[0]), jnp.asarray(valid[0]), IOU))
    monkeypatch.setattr(jpnms.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    pallas = np.asarray(jpnms.greedy_keep_pallas(jnp.asarray(boxes[0]), jnp.asarray(valid[0]), IOU))
    np.testing.assert_array_equal(got, tiled)
    np.testing.assert_array_equal(got, pallas)
    # not vacuous: suppression happened and survivors remain
    assert 0 < got.sum() < valid.sum()


def test_keep_batched_matches_per_image():
    rng = np.random.default_rng(5)
    boxes, valid = _controlled_boxes(rng, 3, 200)
    got = tnms.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), IOU).numpy()
    for i in range(3):
        ref = np.asarray(jnms._greedy_keep_tiled(jnp.asarray(boxes[i]), jnp.asarray(valid[i]), IOU))
        np.testing.assert_array_equal(got[i], ref)


def _row_clusters(rng, k, per=4, w=100.0):
    """k boxes in clusters of ``per`` w x w boxes shifted along x by
    multiples of 11 px, clusters 200 px apart on a grid of class-offset
    tiles, in a shuffled score order, 90 % valid. Two boxes of a cluster
    overlap with IoU (w - dx) / (w + dx): 0.802 at one step (suppresses at
    0.7), 0.639 at two (does not), so every IoU is far from the threshold and
    greedy chains are common."""
    n_cl = -(-k // per)
    cl = np.arange(n_cl)
    x0 = (cl % 32) * 200.0 + tnms.MAX_WH * (cl // 1024)
    y0 = ((cl // 32) % 32) * 200.0
    shift = rng.integers(0, 4, (n_cl, per)) * 11.0
    x = (x0[:, None] + shift).reshape(-1)[:k]
    y = np.repeat(y0, per)[:k]
    boxes = np.stack([x, y, x + w, y + w], -1)[rng.permutation(k)]
    return boxes.astype(np.float32), rng.uniform(size=k) > 0.1


def test_keep_past_old_limit_matches_tiled():
    """k 4100 (past the 4096 the port once refused; JAX's tiled NMS serves
    any k): keep masks bit-equal to _greedy_keep_tiled."""
    rng = np.random.default_rng(4100)
    boxes, valid = _row_clusters(rng, 4100)
    _assert_iou_margin(boxes)
    got = tnms.greedy_keep(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], IOU)[0]
    ref = np.asarray(jnms._greedy_keep_tiled(jnp.asarray(boxes), jnp.asarray(valid), IOU))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < got.sum() < valid.sum() - 100  # suppression happened


def _raw_levels(seed, img=256, nc=3, b=2):
    """NHWC raw head maps with varied DFL distributions and, per image,
    distinct max-class logits (a permuted grid), so that no two candidate
    confidences tie."""
    rng = np.random.default_rng(seed)
    hs = [img // s for s in (8, 16, 32)]
    a = sum(h * h for h in hs)
    top = np.stack([rng.permutation(np.linspace(-4.0, 6.0, a)) for _ in range(b)])
    cls = np.minimum(rng.normal(-6.0, 0.5, (b, a, nc)), -4.5)
    np.put_along_axis(cls, rng.integers(0, nc, (b, a, 1)), top[..., None], axis=2)
    out, off = [], 0
    for h in hs:
        box = rng.normal(0, 2.5, (b, h, h, 64))
        c = cls[:, off:off + h * h].reshape(b, h, h, nc)
        out.append(np.concatenate([box, c], -1).astype(np.float32))
        off += h * h
    return out


def _to_nchw(levels):
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))) for f in levels]


# seeds whose candidate boxes have no IoU within 1e-4 of the threshold
@pytest.mark.parametrize("pre_nms_k,max_det,seed", [(512, 300, 4), (1024, 300, 12),
                                                    (1024, 1024, 18)])
def test_fused_detect_matches_jax(pre_nms_k, max_det, seed):
    nc = 3
    raw = _raw_levels(seed, nc=nc)
    j = jfd.fused_detect([jnp.asarray(f) for f in raw], nc, 0.25, iou_thres=IOU,
                         max_det=max_det, pre_nms_k=pre_nms_k)
    t = tfd.fused_detect(_to_nchw(raw), nc, torch.tensor(0.25), iou_thres=IOU,
                         max_det=max_det, pre_nms_k=pre_nms_k)
    # fixture is non-degenerate: candidate confidences are well separated
    cand = tfd.select_candidates(_to_nchw(raw), nc, 0.25, pre_nms_k)
    for i in range(2):
        conf = cand.conf[i][cand.conf[i] > 0.25]
        assert (conf[:-1] - conf[1:]).min() > 1e-6
        shifted, top_valid = tnms.nms_inputs(cand.boxes[i], cand.conf[i], cand.cls[i], 0.25)
        _assert_iou_margin(shifted.numpy())
        # not vacuous: NMS suppressed some candidates and kept others
        kept = tnms.greedy_keep(shifted[None], top_valid[None], IOU).sum()
        assert 0 < kept < top_valid.sum()
    for field in ("valid", "cls", "anchor_idx"):
        np.testing.assert_array_equal(getattr(t.det, field).numpy(),
                                      np.asarray(getattr(j.det, field)), err_msg=field)
    np.testing.assert_allclose(t.det.boxes.numpy(), np.asarray(j.det.boxes), rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(t.det.conf.numpy(), np.asarray(j.det.conf), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits), rtol=1e-5, atol=1e-6)


def test_suppress_and_select_matches_jax():
    rng = np.random.default_rng(11)
    k, max_det = 512, 300
    boxes, _ = _controlled_boxes(rng, 2, k)
    boxes -= (np.floor(boxes[..., :1] / tnms.MAX_WH) * tnms.MAX_WH)  # undo the class offset
    conf = np.sort(rng.uniform(0, 1, (2, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    cls = rng.integers(0, 3, (2, k)).astype(np.int32)
    idx = rng.permutation(4 * k)[: 2 * k].reshape(2, k).astype(np.int32)
    t_det, t_sel = tnms.suppress_and_select(
        torch.from_numpy(boxes), torch.from_numpy(conf), torch.from_numpy(cls).long(),
        torch.from_numpy(idx).long(), 0.3, IOU, max_det)
    for i in range(2):
        j_det, j_sel = jnms.suppress_and_select(
            jnp.asarray(boxes[i]), jnp.asarray(conf[i]), jnp.asarray(cls[i]), jnp.asarray(idx[i]),
            jnp.float32(0.3), IOU, max_det, False)
        for field in ("valid", "cls", "anchor_idx", "boxes", "conf"):
            np.testing.assert_array_equal(getattr(t_det, field)[i].numpy(),
                                          np.asarray(getattr(j_det, field)), err_msg=field)
        np.testing.assert_array_equal(t_sel[i].numpy(), np.asarray(j_sel))


def test_fused_matches_full_anchor_decode():
    """The lazy path equals decode_detections + batched_nms (the oracle)."""
    nc = 3
    raw = _to_nchw(_raw_levels(12, nc=nc))
    fused = tfd.fused_detect(raw, nc, 0.25, iou_thres=IOU, max_det=100, pre_nms_k=1024)
    boxes, logits, _ = decode_detections(raw, nc)
    full = tnms.batched_nms(boxes, logits, 0.25, iou_thres=IOU, max_det=100, pre_nms_k=1024)
    np.testing.assert_array_equal(fused.det.anchor_idx.numpy(), full.anchor_idx.numpy())
    np.testing.assert_array_equal(fused.det.valid.numpy(), full.valid.numpy())
    np.testing.assert_allclose(fused.det.boxes.numpy(), full.boxes.numpy(), rtol=1e-5, atol=2e-3)


# K1's blocked design (csrc/nms_keep.cu), emulated: the mask phase by
# (row block, column block) pairs of the upper triangle, skipping pairs and
# rows/columns without a valid box, and the sweep by blocks of 64 boxes,
# each block's diagonal resolved in bits and its kept rows ORed into the
# removed words right of the diagonal.

def _k1_mask_words(boxes, valid, thr):
    """(k, nw) python-int words as nms_mask_kernel writes them (words left
    of the diagonal block are never written: None)."""
    k = boxes.shape[0]
    nw = -(-k // 64)
    words = [[None] * nw for _ in range(k)]
    for rb in range(nw):
        rows = range(64 * rb, min(k, 64 * rb + 64))
        for cb in range(rb, nw):
            c0, c1 = 64 * cb, min(k, 64 * cb + 64)
            if not (valid[list(rows)].any() and valid[c0:c1].any()):
                for r in rows:
                    words[r][cb] = 0
                continue
            sup = (box_iou(boxes[list(rows)], boxes[c0:c1]) > thr).numpy()
            for i, r in enumerate(rows):
                bits = 0
                if valid[r]:
                    for j in range(c1 - c0):
                        if c0 + j > r and valid[c0 + j] and sup[i, j]:
                            bits |= 1 << j
                words[r][cb] = bits
    return words


def _k1_blocked_sweep(words, valid):
    """nms_sweep_kernel on one image: -> (k,) bool keep mask."""
    k, nw = len(words), len(words[0])
    vbits = [sum(int(valid[64 * w + j]) << j for j in range(min(64, k - 64 * w)))
             for w in range(nw)]
    nb = max((w + 1 for w in range(nw) if vbits[w]), default=0)
    removed = [0] * nw
    keep = np.zeros(k, bool)
    for i in range(nb):
        rem, kept = removed[i], 0
        for r in range(min(64, k - 64 * i)):
            if (vbits[i] >> r) & 1 and not (rem >> r) & 1:
                kept |= 1 << r
                rem |= words[64 * i + r][i]
                keep[64 * i + r] = True
        for w in range(i + 1, nb):  # later words hold no valid box
            for r in range(64):
                if (kept >> r) & 1:
                    removed[w] |= words[64 * i + r][w]
    return keep


def _k1_case(kind, k):
    rng = np.random.default_rng(k + len(kind))
    if kind == "chain":
        from ood_in_object_detection_torch.scripts.bench_k1_k4 import chain_boxes

        boxes, valid = chain_boxes(1, k)
        return boxes[0].astype(np.float32), valid[0]
    boxes, valid = _controlled_boxes(rng, 1, k)
    boxes, valid = boxes[0], valid[0]
    if kind == "random":
        c, wh = rng.uniform(0, 640, (k, 2)), rng.uniform(5, 200, (k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        valid = rng.uniform(size=k) > 0.2
    elif kind == "all_valid":
        valid = np.ones(k, bool)
    elif kind == "all_invalid":
        valid = np.zeros(k, bool)
    elif kind == "prefix_valid":
        valid = np.arange(k) < (3 * k) // 5 + 1
    return boxes, valid  # "nonprefix_valid": the random 90 % of _controlled_boxes


@pytest.mark.parametrize("k", [1, 63, 64, 65, 189, 1024])
@pytest.mark.parametrize("kind", ["random", "all_valid", "all_invalid", "prefix_valid",
                                  "nonprefix_valid", "chain"])
def test_k1_blocked_sweep_matches_plain(kind, k):
    boxes, valid = _k1_case(kind, k)
    keep = _k1_blocked_sweep(_k1_mask_words(torch.from_numpy(boxes), valid, IOU), valid)
    ref = tnms.greedy_keep_plain(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
                                 IOU)[0].numpy()
    np.testing.assert_array_equal(keep, ref)
    if kind == "chain":  # greedy keeps every second box; one pass would keep one
        np.testing.assert_array_equal(ref, np.arange(k) % 2 == 0)
