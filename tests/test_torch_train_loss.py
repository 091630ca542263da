"""The port's Task-Aligned Assigner, detection losses, LR schedule and SGD
(train/{tal,loss,trainer}.py) against the JAX package's on the CPU, on
seeded numpy inputs; no model is built.

Tolerances: TAL's fg_mask and target_gt_idx are equal exactly, its target
boxes and scores within 1e-6 (absolute; boxes are gathers, scores are
products of values below 1). Loss terms within 1e-5 relative and their
gradients with respect to the raw maps within 1e-5 of the largest gradient
magnitude (f32 sums in another order). The schedule within 1e-6 relative
(np.cos against jnp.cos in f32). SGD parameters after 103 steps within
1e-5 of each tensor's largest magnitude: each step rounds its
multiply-adds in f32 (XLA fuses some into FMAs), and the momentum buffer
carries each rounding on (about x16 at momentum 0.937); a wrong rule (no
Nesterov term, the wrong group's LR or decay) moves them by percents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.models.head import REG_MAX, make_anchors
from ood_in_object_detection_torch.models.layers import Conv
from ood_in_object_detection_torch.train import loss as TL
from ood_in_object_detection_torch.train import tal as TT
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_tpu.train import loss as JL
from ood_in_object_detection_tpu.train import tal as JT
from ood_in_object_detection_tpu.train import trainer as JTR

IMG = 64
HW = [(8, 8), (4, 4), (2, 2)]
NC = 3


def anchor_points():
    anc, strides = make_anchors(HW)
    return (anc * strides[:, None]).numpy()


def tal_case(kind: str, seed: int):
    """Assigner inputs in pixels: B 2, the 84 anchors of a 64 px image, M 5
    gts, NC 3. ``kind``: ``random``; ``ties`` (every anchor predicts the
    box, which every gt overlaps, with the same scores, so every candidate
    of a gt has the same metric); ``zero_metric`` (gt 0's class scores 0 everywhere); ``masked``
    (masked gts overlapping the valid ones); ``duplicates`` (gts 1 and 3
    repeat gt 0's box, one with its label, one with another)."""
    rng = np.random.default_rng(seed)
    anc = anchor_points()
    A, B, M = len(anc), 2, 5
    xy = rng.uniform(0, IMG - 24, (B, M, 2))
    wh = rng.uniform(12, 40, (B, M, 2))
    gt_b = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(np.float32)
    gt_l = rng.integers(0, NC, (B, M)).astype(np.int32)
    gt_m = np.ones((B, M), bool)
    gt_m[1, 4] = False
    scores = rng.uniform(0.01, 0.99, (B, A, NC)).astype(np.float32)
    c = anc[None] + rng.normal(0, 3, (B, A, 2))
    half = rng.uniform(4, 20, (B, A, 2))
    pd_b = np.concatenate([c - half, c + half], -1).astype(np.float32)
    topk = 10
    if kind == "ties":
        pd_b[:] = np.float32([16, 16, 48, 48])
        scores[:] = 0.5
    elif kind == "zero_metric":
        for b in range(B):
            scores[b, :, gt_l[b, 0]] = 0.0
    elif kind == "masked":
        gt_m[:, 1] = False
        gt_b[:, 1] = gt_b[:, 0] + np.float32(2.0)
    elif kind == "duplicates":
        gt_b[:, 1] = gt_b[:, 0]
        gt_b[:, 3] = gt_b[:, 0]
        gt_l[:, 1] = gt_l[:, 0]
        gt_l[:, 3] = (gt_l[:, 0] + 1) % NC
        topk = 4
    return dict(pd_scores=scores, pd_bboxes=pd_b, anc_points=anc, gt_labels=gt_l,
                gt_bboxes=gt_b, gt_mask=gt_m, topk=topk)


@pytest.mark.parametrize("kind", ["random", "ties", "zero_metric", "masked", "duplicates"])
@pytest.mark.parametrize("seed", [0, 1])
def test_assign_matches_jax(kind, seed):
    case = tal_case(kind, seed)
    topk = case.pop("topk")
    j = JT.assign(*(jnp.asarray(v) for v in case.values()), topk=topk)
    t = TT.assign(*(torch.from_numpy(v) for v in case.values()), topk=topk)
    fg = np.asarray(j.fg_mask)
    assert fg.any() and not fg.all()
    np.testing.assert_array_equal(t.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(t.target_gt_idx.numpy(), np.asarray(j.target_gt_idx))
    np.testing.assert_allclose(t.target_bboxes.numpy(), np.asarray(j.target_bboxes), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t.target_scores.numpy(), np.asarray(j.target_scores), rtol=0,
                               atol=1e-6)
    if kind == "ties":  # the first candidates by index win, as in the JAX rounds
        assert np.asarray(j.target_scores).max() > 0


def test_ciou_and_iou_match_jax():
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.uniform(0, 50, (40, 2)), rng.uniform(51, 90, (40, 2))], 1)
    b = np.concatenate([rng.uniform(0, 50, (40, 2)), rng.uniform(51, 90, (40, 2))], 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_allclose(TT.ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(JT.ciou(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    np.testing.assert_allclose(TT.iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(JT.iou_xyxy(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


def raw_case(seed: int, nc: int = NC):
    """Raw maps (NHWC numpy, the JAX layout) with class logits raised inside
    the gts, and the gts of tal_case('random')."""
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1, (2, h, w, 4 * REG_MAX + nc)).astype(np.float32) for h, w in HW]
    raw[0][:, 1:5, 1:5, 4 * REG_MAX:] += 3.0
    case = tal_case("random", seed)
    return raw, case["gt_labels"], case["gt_bboxes"], case["gt_mask"]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_and_gradient_match_jax(seed):
    raw, gl, gb, gm = raw_case(seed)

    def jf(r):
        lb = JL.detection_loss(r, jnp.asarray(gl), jnp.asarray(gb), jnp.asarray(gm), NC)
        return lb.total, lb

    (_, jlb), jg = jax.value_and_grad(jf, has_aux=True)([jnp.asarray(r) for r in raw])
    tr = [torch.from_numpy(r).permute(0, 3, 1, 2).contiguous().requires_grad_() for r in raw]
    tlb = TL.detection_loss(tr, torch.from_numpy(gl), torch.from_numpy(gb),
                            torch.from_numpy(gm), NC)
    tlb.total.backward()
    for a, b in zip(tlb, jlb):
        assert _rel(a.detach(), b) <= 1e-5
    assert float(jlb.box) > 0 and float(jlb.dfl) > 0
    for g, r in zip(jg, tr):
        g = np.asarray(g)
        np.testing.assert_allclose(r.grad.permute(0, 2, 3, 1).numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


def test_v10_detection_loss_and_gradient_match_jax():
    many, gl, gb, gm = raw_case(4)
    one = raw_case(5)[0]

    def jf(a, b):
        lb = JL.v10_detection_loss(a, b, jnp.asarray(gl), jnp.asarray(gb), jnp.asarray(gm), NC)
        return lb.total, lb

    (_, jlb), (jga, jgb) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(r) for r in many], [jnp.asarray(r) for r in one])
    ta = [torch.from_numpy(r).permute(0, 3, 1, 2).contiguous().requires_grad_() for r in many]
    tb = [torch.from_numpy(r).permute(0, 3, 1, 2).contiguous().requires_grad_() for r in one]
    tlb = TL.v10_detection_loss(ta, tb, torch.from_numpy(gl), torch.from_numpy(gb),
                                torch.from_numpy(gm), NC)
    tlb.total.backward()
    for a, b in zip(tlb, jlb):
        assert _rel(a.detach(), b) <= 1e-5
    for gs, ts in ((jga, ta), (jgb, tb)):
        for g, r in zip(gs, ts):
            g = np.asarray(g)
            np.testing.assert_allclose(r.grad.permute(0, 2, 3, 1).numpy(), g, rtol=0,
                                       atol=1e-5 * np.abs(g).max())


def test_df_loss_and_bce_match_jax():
    rng = np.random.default_rng(6)
    d = rng.normal(0, 2, (7, 4, REG_MAX)).astype(np.float32)
    t = rng.uniform(0, REG_MAX - 1.01, (7, 4)).astype(np.float32)
    np.testing.assert_allclose(TL.df_loss(torch.from_numpy(d), torch.from_numpy(t)).numpy(),
                               np.asarray(JL.df_loss(jnp.asarray(d), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)
    x = rng.normal(0, 3, 50).astype(np.float32)
    y = rng.uniform(0, 1, 50).astype(np.float32)
    np.testing.assert_allclose(TL.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y)),
                               np.asarray(JL.bce_with_logits(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)


CONFIGS = {
    "warmup": dict(warmup_epochs=1.0, steps_per_epoch=10, epochs=30),
    "no_warmup": dict(warmup_epochs=0.0, steps_per_epoch=10, epochs=30),
    "cos_lr": dict(warmup_epochs=1.0, steps_per_epoch=10, epochs=30, cos_lr=True),
    "long_warmup": dict(warmup_epochs=3.0, steps_per_epoch=70, epochs=5, lrf=0.2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hyper_at_matches_jax(name):
    """(lr_bias, lr_rest, momentum) at steps on both sides of the warmup
    boundary and of epoch boundaries."""
    jc, tc = JTR.TrainConfig(**CONFIGS[name]), TTR.TrainConfig(**CONFIGS[name])
    assert JTR._warmup_iters(jc) == TTR._warmup_iters(tc)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 101, 150, 209, 210, 299, 349):
        j = [float(v) for v in JTR._hyper_at(jc, step)]
        t = [float(v) for v in TTR._hyper_at(tc, step)]
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        assert float(TTR.lr_schedule(tc)(step)) == pytest.approx(float(JTR.lr_schedule(jc)(step)),
                                                                 rel=1e-6)


class Tiny(nn.Module):
    """A small named tree: two Conv blocks (kernel, BN scale and bias) and a
    biased 1x1 conv, named as the detector's layers are."""

    def __init__(self):
        super().__init__()
        self.model = nn.ModuleList([Conv(3, 4, 3), Conv(4, 5, 1), nn.Conv2d(5, 2, 1)])


def _jax_tree(values):
    """The JAX package's tree for Tiny's parameters (torch layouts kept: the
    update is elementwise), keyed as flax names them."""
    def conv(i):
        return {"conv": {"kernel": values[f"model.{i}.conv.weight"]},
                "bn": {"scale": values[f"model.{i}.bn.weight"],
                       "bias": values[f"model.{i}.bn.bias"]}}

    return {"l0_Conv": conv(0), "l1_Conv": conv(1),
            "l2_Raw": {"kernel": values["model.2.weight"], "bias": values["model.2.bias"]}}


@pytest.mark.parametrize("name,freeze", [("warmup", False), ("cos_lr", False),
                                         ("no_warmup", False), ("warmup", True)])
def test_sgd_matches_reference_sgd(name, freeze):
    """103 steps of the port's three-group Nesterov SGD against the JAX
    package's reference_sgd (make_optimizer, with freeze where asked) on the
    same gradients: across the warmup boundary (step 100) and the epoch
    boundaries, with cos_lr, and with layer 0 frozen (no update, no
    momentum buffer)."""
    kw = dict(CONFIGS[name], weight_decay=5e-2)
    tc = TTR.TrainConfig(**kw, freeze_prefixes=("model.0.",) if freeze else ())
    jc = JTR.TrainConfig(**kw, freeze_prefixes=("l0_",) if freeze else ())
    rng = np.random.default_rng(7)
    m = Tiny()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32)))
    p0 = {n: p.detach().numpy().copy() for n, p in m.named_parameters()}
    opt = TTR.make_optimizer(m, tc)
    tx = JTR.make_optimizer(jc)
    jp = jax.tree.map(jnp.asarray, _jax_tree(p0))
    js = tx.init(jp)
    update = jax.jit(tx.update)
    for step in range(103):
        g = {n: rng.normal(0, 1, p.shape).astype(np.float32) for n, p in m.named_parameters()}
        for n, p in m.named_parameters():
            p.grad = torch.from_numpy(g[n]) if p.requires_grad else None
        TTR.sgd_step(opt, tc, step)
        u, js = update(jax.tree.map(jnp.asarray, _jax_tree(g)), js, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, u)
    got = _jax_tree({n: p.detach().numpy() for n, p in m.named_parameters()})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    if freeze:
        for n in ("model.0.conv.weight", "model.0.bn.weight", "model.0.bn.bias"):
            p = dict(m.named_parameters())[n]
            np.testing.assert_array_equal(p.detach().numpy(), p0[n])
            assert p not in opt.state
    assert len(opt.state) == (5 if freeze else 8)
