"""Data-parallel training on two gloo ranks on the CPU
(``train/trainer.py:make_sharded_train_step``, ``models/layers.py:bn_train``
inside ``parallel/distributed.py:global_batch``) against the JAX package's
``make_sharded_train_step`` on a data=2 mesh and against the port's own
single-process ``train_step`` on the global batch.

The setting is tests/test_torch_train_step.py's: yolov8n at 64 px, nc 2,
batch 2 (one image a rank), warmup_epochs 0, the port's seeded init carried
to JAX. After one step: loss terms within 2e-4 relative of JAX's (the JAX
DP test's tolerance; the readings are ~1e-7), every parameter, BatchNorm
statistic, EMA value and momentum buffer within the single-device test's
tolerance (1e-3 of its tensor's largest move plus one or two float32 ulps
of the value); the two ranks' states bit-identical. Every rank is joined
within 120 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import CFG, jax_dicts, make_batch, port_dicts, shared_start, within
from torch_threads import _two_threads  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks
from ood_in_object_detection_torch.models.layers import bn_train
from ood_in_object_detection_torch.parallel.distributed import spawn
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_tpu.parallel import device_put_batch as jax_put_batch
from ood_in_object_detection_tpu.parallel import make_mesh as jax_make_mesh
from ood_in_object_detection_tpu.train import trainer as JTR

JOIN_S = 120
# the remat + freeze variant (train/trainer.py: both still work data parallel)
REMAT_FREEZE = dict(CFG, remat=True, freeze_prefixes=("model.0.", "model.1."))


def bn_case():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (4, 6, 5, 3)).astype(np.float32))
    upstream = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, 6).astype(np.float32))
    running = (torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32)),
               torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
    return x, upstream, weight, bias, running


@pytest.fixture(scope="module")
def dp():
    """Two gloo ranks: bn_train on a shard each, then one sharded step in
    the test config and in REMAT_FREEZE (one spawn)."""
    return spawn(ranks.bn_and_steps, ["cpu", "cpu"],
                 args=(bn_case(), [CFG, REMAT_FREEZE], make_batch()), join_timeout=JOIN_S,
                 threads=2)


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's make_sharded_train_step (one compile) on a data=2 mesh from the
    shared init: (loss terms, state before, state after)."""
    tm, jm, js, _ = shared_start()
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    before = jax_dicts(js, tm.detect_layer_idx)
    with mesh:
        placed = jax_put_batch({k: jnp.asarray(v) for k, v in make_batch().items()}, mesh)
        js1, jlb = JTR.make_sharded_train_step(jm, JTR.TrainConfig(**CFG), mesh)(
            JTR.shard_state(js, mesh), placed)
    return [float(v) for v in jlb], before, jax_dicts(js1, tm.detect_layer_idx)


@pytest.fixture(scope="module")
def single():
    """The port's single-process train_step on the global batch, per config:
    (loss terms, state before, state after)."""
    out = []
    for kw in (CFG, REMAT_FREEZE):
        tm, _, _, sd = shared_start()
        cfg = TTR.TrainConfig(**kw)
        ts = TTR.init_state(tm, cfg)
        ts, lb = TTR.train_step(tm, cfg, ts, make_batch())
        out.append(([float(v) for v in lb], sd, port_dicts(ts)))
    return out


def test_global_batchnorm_equals_the_concatenated_batch(dp):
    """bn_train on two ranks' shards inside global_batch: the outputs and
    dL/dx of each shard, the summed dL/dscale and dL/dbias, and the pending
    running statistics (the same on both ranks) equal bn_train on the
    concatenated batch."""
    x, upstream, weight, bias, running = bn_case()
    bn = torch.nn.BatchNorm2d(6, eps=1e-3)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(running[0])
        bn.running_var.copy_(running[1])
    xf = x.clone().requires_grad_(True)
    y = bn_train(bn, xf)
    (y * upstream).sum().backward()
    parts = [r["bn"] for r in dp]
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([p["y"] for p in parts]), y.detach(), **tol)
    torch.testing.assert_close(torch.cat([p["dx"] for p in parts]), xf.grad, **tol)
    torch.testing.assert_close(parts[0]["dscale"] + parts[1]["dscale"], bn.weight.grad, **tol)
    torch.testing.assert_close(parts[0]["dbias"] + parts[1]["dbias"], bn.bias.grad, **tol)
    for p in parts:
        for got, want in zip(p["pending"], bn.pending_stats):
            torch.testing.assert_close(got, want, **tol)
    assert all(torch.equal(a, b) for a, b in zip(parts[0]["pending"], parts[1]["pending"]))
    # the global statistics, not a shard's: a rank's own would differ
    local = x[:2]
    assert (parts[0]["pending"][0] - (0.97 * running[0] + 0.03 * local.mean((0, 2, 3)))
            ).abs().max() > 1e-3


@pytest.mark.parametrize("variant", [0, 1])
def test_ranks_stay_identical(dp, variant):
    """Parameters, BatchNorm statistics, EMA, momentum buffers and step: the
    same bytes on both ranks after the step; the logged loss terms are the
    global ones on both."""
    a, b = (r["steps"][variant] for r in dp)
    assert a["digest"] == b["digest"] and a["step"] == b["step"] == 1
    assert a["loss"] == b["loss"]


def test_sharded_step_matches_jax(dp, jax_dp):
    jlb, before, (jp, jema, jtrace) = jax_dp
    r = dp[0]["steps"][0]
    for t, j in zip(r["loss"], jlb):
        assert abs(t - j) <= 2e-4 * abs(j), (r["loss"], jlb)
    tp, tema, tbuf = r["dicts"]
    bp, bema, _ = before
    params = {k: v for k, v in jp.items() if not k.endswith(("running_mean", "running_var"))}
    stats = {k: v for k, v in jp.items() if k.endswith(("running_mean", "running_var"))}
    assert within(tp, params, bp, what="params") > 100
    assert within(tp, stats, bp, what="batch stats") > 100
    assert within(tema, {k: jema[k] for k in tema if k in params}, bema, what="ema",
                  ulps=2) > 100
    assert within(tbuf, {k: jtrace[k] for k in tbuf}, None, what="momentum") > 100


@pytest.mark.parametrize("variant", [0, 1])
def test_sharded_step_matches_single_process(dp, single, variant):
    """The sharded step against the port's train_step on the global batch
    (variant 1: remat and a frozen backbone prefix, whose parameters stay
    put and take no momentum buffer)."""
    r = dp[0]["steps"][variant]
    slb, before, (sp, sema, sbuf) = single[variant]
    for t, s in zip(r["loss"], slb):
        assert abs(t - s) <= 1e-5 * abs(s), (r["loss"], slb)
    tp, tema, tbuf = r["dicts"]
    assert set(tbuf) == set(sbuf)
    assert within(tp, sp, before, what="params and stats") > 100
    assert within(tema, {k: sema[k] for k in tema}, before, what="ema", ulps=2) > 100
    assert within(tbuf, sbuf, None, what="momentum") > 100
    if variant == 1:
        frozen = [k for k in tp if k.startswith(("model.0.conv", "model.1.conv"))]
        assert frozen and all(np.array_equal(tp[k], before[k]) for k in frozen)
        assert not any(k.startswith(("model.0.", "model.1.")) for k in tbuf)
