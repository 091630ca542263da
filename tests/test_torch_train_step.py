"""The port's train step (train/trainer.py) against the JAX package's on the
CPU: yolov8n at 64 px, nc 2, batch 2, warmup_epochs 0 (so that the first
step moves every group), the port's seeded init carried to JAX through
export_state_dict / import_state_dict.

After one step from the shared init, and after the fifth step, each step
from 2 to 5 started from JAX's state (parameters, BatchNorm statistics,
EMA, momentum buffers and step count carried into the port): loss terms
within 1e-5 relative; every parameter, BatchNorm statistic, EMA value and
momentum buffer within 1e-3 of its tensor's largest move in that step (the
momentum buffer: of its largest magnitude), plus one float32 ulp of the
value, the rounding of ``value + move``, which no sum order avoids (two
for the EMA: the parameter it averages, and its own ``e * d + p * (1 - d)``).

Why steps 2-5 restart from JAX's state: the trajectories part at ~x10 a
step. The assignments stay equal (fg masks and gt indices, checked on
these inputs), but flax's BatchNorm takes the variance as E[x^2] - E[x]^2
in f32, whose cancellation turns last-bit differences of the weights into
~1e-5 of the loss at the next step; the JAX package itself parts so from
another summation order. Each step is compared from the same state.

One bf16 step (f32 parameters, bf16 compute) from the same init: loss
terms within 2e-2 relative, each tensor's move within 2.5x the distance
between JAX's own bf16 and f32 moves (test_bf16_train_step_matches_jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import _two_threads  # noqa: F401 (autouse)

from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_torch.utils.weights import numpy_state_dict
from ood_in_object_detection_tpu.models import build_model as jax_build_model
from ood_in_object_detection_tpu.train import trainer as JTR
from ood_in_object_detection_tpu.utils.weight_import import export_state_dict, import_state_dict

IMG, NC = 64, 2
CFG = dict(lr0=0.01, epochs=10, steps_per_epoch=5, warmup_epochs=0.0)


def make_batch():
    rng = np.random.default_rng(0)
    return dict(images=rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32),
                gt_labels=np.array([[0, 1, 0], [1, 0, 0]], np.int32),
                gt_bboxes=np.array([[[4, 6, 30, 40], [30, 20, 60, 62], [0, 0, 0, 0]],
                                    [[10, 10, 50, 40], [2, 30, 25, 60], [0, 0, 0, 0]]],
                                   np.float32),
                gt_mask=np.array([[1, 1, 0], [1, 1, 0]], bool))


def shared_start(dtype=torch.float32, jdtype=jnp.float32):
    """-> (port model, JAX model, JAX TrainState) from the port's seeded
    init, and the init's numpy state_dict."""
    tm = build_model("yolov8n", nc=NC, dtype=dtype)
    init_weights(tm, torch.Generator().manual_seed(0))
    sd = numpy_state_dict(tm)
    jm = jax_build_model("yolov8n", nc=NC, dtype=jdtype)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    v, missing = import_state_dict(shapes, sd, tm.detect_layer_idx, strict=True)
    assert not missing
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = JTR.make_optimizer(JTR.TrainConfig(**CFG))
    js = JTR.TrainState(params, jax.tree.map(jnp.asarray, v["batch_stats"]), tx.init(params),
                        params, jnp.zeros((), jnp.int32))
    return tm, jm, js, sd


def jax_dicts(js, idx):
    """JAX's parameters (with BatchNorm statistics), EMA and momentum trace
    as torch-named numpy state_dicts."""
    def sd(tree):
        return export_state_dict({"params": tree, "batch_stats": js.batch_stats}, idx)

    return sd(js.params), sd(js.ema_params), sd(js.opt_state[1])


def anchor(ts, js):
    """Set the port's state to JAX's."""
    params, ema, trace = jax_dicts(js, ts.model.detect_layer_idx)
    ts.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    TTR.load_ema(ts, {k: torch.from_numpy(np.array(v)) for k, v in ema.items()})
    named = dict(ts.model.named_parameters())
    for n, p in named.items():
        if p.requires_grad:
            ts.optimizer.state[p]["momentum_buffer"] = torch.from_numpy(np.array(trace[n]))
    ts.step = int(js.step)


def port_dicts(ts):
    named = dict(ts.model.named_parameters())
    buf = {n: ts.optimizer.state[p]["momentum_buffer"].numpy().copy()
           for n, p in named.items() if p in ts.optimizer.state}
    ema = {k: v.numpy().copy() for k, v in ts.ema_params.items()}
    return numpy_state_dict(ts.model), ema, buf


def within(got, want, before, frac=1e-3, what="", ulps=1, floor=0.0):
    """Every entry of ``got`` within ``frac`` of the tensor's largest move
    from ``before`` (None: of its largest magnitude) plus ``ulps`` ulps of
    the value. With ``floor``, a tensor's move counts as at least ``floor``
    times the largest move of all the tensors compared (for tensors whose
    move is rounding noise)."""
    def largest(k, w):
        return np.abs(w - before[k]).max() if before is not None else np.abs(w).max()

    keys = {k for k in want if k in got and not k.endswith("num_batches_tracked")
            and not k.endswith("dfl.conv.weight")}
    least = floor * max(largest(k, np.asarray(want[k], np.float32)) for k in keys) if floor else 0
    checked = 0
    for k, w in want.items():
        if k not in keys:
            continue
        w = np.asarray(w, np.float32)
        move = max(largest(k, w), least)
        tol = frac * move + ulps * np.spacing(np.abs(w))
        bad = np.abs(got[k] - w) > tol
        assert not bad.any(), (what, k, float(np.abs(got[k] - w).max()), float(move))
        checked += 1
    return checked


@pytest.fixture(scope="module")
def f32_run():
    """One JAX compile of the f32 step; the port and JAX after step 1 from
    the shared init and after step 5 (steps 2-5 each from JAX's state)."""
    tm, jm, js, sd = shared_start()
    jcfg, tcfg = JTR.TrainConfig(**CFG), TTR.TrainConfig(**CFG)
    step = jax.jit(lambda s, b: JTR.train_step(jm, jcfg, s, b))
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ts = TTR.init_state(tm, tcfg)
    out = {}
    for i in range(5):
        before = jax_dicts(js, tm.detect_layer_idx)
        if i:
            anchor(ts, js)
        js, jlb = step(js, jb)
        ts, tlb = TTR.train_step(tm, tcfg, ts, batch)
        if i in (0, 4):
            out[i + 1] = dict(jlb=[float(v) for v in jlb], tlb=[float(v) for v in tlb],
                              before=before, jax=jax_dicts(js, tm.detect_layer_idx),
                              port=port_dicts(ts), step=ts.step)
    return out, sd


@pytest.mark.parametrize("after", [1, 5])
def test_train_step_losses_match_jax(f32_run, after):
    r = f32_run[0][after]
    for t, j in zip(r["tlb"], r["jlb"]):
        assert abs(t - j) <= 1e-5 * abs(j), (r["tlb"], r["jlb"])
    assert r["step"] == after


@pytest.mark.parametrize("after", [1, 5])
def test_train_step_state_matches_jax(f32_run, after):
    r = f32_run[0][after]
    (jp, jema, jtrace), (tp, tema, tbuf) = r["jax"], r["port"]
    bp, bema, _ = r["before"]
    params = {k: v for k, v in jp.items() if not k.endswith(("running_mean", "running_var"))}
    stats = {k: v for k, v in jp.items() if k.endswith(("running_mean", "running_var"))}
    assert within(tp, params, bp, what="params") > 100
    assert within(tp, stats, bp, what="batch stats") > 100
    assert within(tema, {k: jema[k] for k in tema if k in params}, bema, what="ema",
                  ulps=2) > 100
    assert within(tbuf, {k: jtrace[k] for k in tbuf}, None, what="momentum") > 100
    # the step moved most trained tensors (every one with weight decay)
    moved = [k for k in tbuf if np.abs(np.asarray(jp[k]) - bp[k]).max() > 0]
    assert len(moved) >= 0.9 * len(tbuf) and all(k in moved for k in tbuf if tbuf[k].ndim == 4)


def test_batch_stats_are_flax_biased_variance(f32_run):
    """The running variance after step 1 is 0.97 + 0.03 * the biased batch
    variance (JAX's, held above), not nn.BatchNorm2d's unbiased update: the
    two differ by n / (n - 1), 8 / 7 at P5 (2 x 2 x 2 values a channel)."""
    r, sd = f32_run[0][1], f32_run[1]
    key = "model.21.cv2.bn.running_var"
    got, before = r["port"][0][key], sd[key]
    np.testing.assert_allclose(got, r["jax"][0][key], rtol=1e-5)
    batch_var = (got - 0.97 * before) / 0.03
    unbiased = 0.97 * before + 0.03 * batch_var * 8 / 7
    assert np.abs(unbiased - got).max() > 100 * np.abs(got - r["jax"][0][key]).max()


def test_bf16_train_step_matches_jax(f32_run):
    """One bf16 step from the shared init. Rounding to 8 bits at every layer
    of the forward and the backward, in another order on each side, moves a
    random network's update as far as bf16 moves it from f32: so each
    tensor's move is held to 2.5x the distance (L2) between JAX's own bf16
    and f32 moves (readings on these inputs: median 0.90x, largest 1.55x over
    the 183 tensors), and the loss terms within 2e-2 relative."""
    tm, jm, js, sd = shared_start(torch.bfloat16, jnp.bfloat16)
    jcfg, tcfg = JTR.TrainConfig(**CFG), TTR.TrainConfig(**CFG)
    batch = make_batch()
    js, jlb = jax.jit(lambda s, b: JTR.train_step(jm, jcfg, s, b))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tlb = TTR.train_step(tm, tcfg, TTR.init_state(tm, tcfg), batch)
    for t, j in zip(tlb, jlb):
        assert abs(float(t) - float(j)) <= 2e-2 * abs(float(j)), (tlb, jlb)
    jp = jax_dicts(js, tm.detect_layer_idx)[0]
    j32 = f32_run[0][1]["jax"][0]
    tp = numpy_state_dict(tm)
    n = 0
    for k, w in jp.items():
        if k.endswith(("num_batches_tracked", "dfl.conv.weight")):
            continue
        move_j, move_t, move_32 = np.asarray(w) - sd[k], tp[k] - sd[k], np.asarray(j32[k]) - sd[k]
        gap = np.linalg.norm(move_j - move_32)  # 0 where no gradient reaches the tensor
        assert np.linalg.norm(move_t - move_j) <= 2.5 * gap + np.spacing(np.abs(w)).max(), k
        n += 1
    assert n > 200
