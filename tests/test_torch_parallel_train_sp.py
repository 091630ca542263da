"""Spatial and tensor parallelism in training on two gloo ranks on the CPU
(``parallel/distributed.py``'s collectives with gradients,
``parallel/spatial.py:RankShard``, ``train/trainer.py`` on ``sp`` and
``model`` meshes) against the JAX package and against the unsharded
computations.

One spawn (two 'cpu' ranks, joined within 120 s) runs:

- the collectives alone, against the same computation on the whole
  tensor: the halo window (a k3/s1 and a k3/s2 conv, a k5 max-pool padded
  with -inf) forward and its backward, which returns each halo row's
  gradient to its owner; the row gather's two backwards (summed over the
  group then this rank's rows, under a map that mixes rows; this rank's
  rows of its own gradient, under a loss every rank computes whole); the
  tensor-parallel pair around a dense conv with a bias and a depthwise
  conv split over ``model`` (models/layers.py:conv_in_dtype). Tolerance:
  1e-5 relative and absolute (the same sums in another order);
- one train step in tests/test_torch_train_step.py's setting (yolov8n at
  64 px, nc 2, batch 2, warmup_epochs 0, the port's seeded init carried to
  JAX) on data 1 x sp 2 and on model 2, each against JAX's
  ``make_sharded_train_step`` on data 1 x sp 2 of two virtual devices, the
  one JAX compile here: JAX's global step, which the JAX package's own
  tests hold to its unsharded step (XLA:CPU cannot run JAX's channel-split
  step; a second compile, of the unsharded step, would cost ~20 s more of
  the tier-1 run for the same reference). Loss terms within 2e-4
  relative (the JAX multichip test's); parameters, BatchNorm statistics,
  EMA and momentum within ``within`` (1e-3 of the tensor's largest move
  plus one or two float32 ulps of the value; oneDNN sums a slab's conv in
  another order, ~3e-5 of a map's scale);
- yolo11n (attention on the gathered map) and yolov10n (the dual head)
  on sp 2 against the port's single-process ``train_step`` on the global
  batch (itself held to JAX by test_torch_train_step.py): loss terms within
  1e-5 relative, the state within ``within`` at 2e-3 of a tensor's largest
  move and with a floor: a tensor whose move is under 1e-4 of the state's
  largest is held as if it moved that much. These random networks amplify
  the slabs' other summation order through attention: the readings reach
  1.13e-3, and the single-process step itself moves a gradient by up to
  6.3e-4 of its tensor's largest between 1 and 4 threads (oneDNN off).
  The floored moves are rounding noise: the gradients of BatchNorm biases
  in front of another batch normalisation are 0 in exact arithmetic, and
  the single-process step moves them ~1e-10, by different amounts at 1
  and 4 threads.

Ranks of one ``model`` index end bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_train_step import CFG, jax_dicts, make_batch, port_dicts, shared_start, within
from torch_threads import _two_threads  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.parallel.distributed import spawn
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_tpu.parallel import device_put_batch as jax_put_batch
from ood_in_object_detection_tpu.parallel import make_mesh as jax_make_mesh
from ood_in_object_detection_tpu.train import trainer as JTR

JOIN_S = 120
UNIT_TOL = dict(rtol=1e-5, atol=1e-5)
WINDOWS = [(3, 1, 1, 0.0), (3, 2, 1, 0.0), (5, 1, 2, float("-inf"))]
FAMILIES = ("yolo11n", "yolov10n")
FAMILY_FRAC, NOISE_FLOOR = 2e-3, 1e-4
RUNS = [dict(axes=dict(sp=2), cfg=CFG), dict(axes=dict(model=2), cfg=CFG)] + \
    [dict(axes=dict(sp=2), cfg=CFG, name=n) for n in FAMILIES]


def units_case():
    rng = np.random.default_rng(5)
    convs = [torch.nn.Conv2d(4, 8, 3, 1, 1, bias=True),
             torch.nn.Conv2d(4, 4, 3, 2, 1, groups=4, bias=False)]
    with torch.no_grad():
        for c in convs:
            c.weight.copy_(torch.from_numpy(rng.normal(0, 0.3, c.weight.shape).astype(np.float32)))
            if c.bias is not None:
                c.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, c.bias.shape).astype(np.float32)))
    return dict(x=torch.from_numpy(rng.normal(0, 1, (2, 4, 8, 5)).astype(np.float32)),
                mix=torch.from_numpy(rng.normal(0, 1, (8, 8)).astype(np.float32)),
                windows=WINDOWS, convs=convs)


@pytest.fixture(scope="module")
def worlds():
    """The one spawn: the collectives' units, then each run of RUNS."""
    return spawn(ranks.train_worlds, ["cpu", "cpu"],
                 args=([dict(kw, batch=make_batch()) for kw in RUNS], units_case()),
                 join_timeout=JOIN_S, threads=1)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's step from the shared init, sharded on data 1 x sp 2 (one
    compile) -> (before, loss terms, state after)."""
    tm, jm, js, _ = shared_start()
    idx = tm.detect_layer_idx
    jcfg = JTR.TrainConfig(**CFG)
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    mesh = jax_make_mesh(data=1, sp=2, devices=jax.devices()[:2])
    with mesh:
        placed = jax_put_batch(batch, mesh)
        assert placed["images"].sharding.spec == jax.sharding.PartitionSpec(
            ("dcn", "data"), "sp", None, None)
        js1, jlb = JTR.make_sharded_train_step(jm, jcfg, mesh)(JTR.shard_state(js, mesh), placed)
    return jax_dicts(js, idx), [float(v) for v in jlb], jax_dicts(js1, idx)


def test_halo_window_returns_each_halo_rows_gradient_to_its_owner(worlds):
    case = units_case()
    x = case["x"].clone().requires_grad_(True)
    for i, (k, s, p, fill) in enumerate(WINDOWS):
        x.grad = None
        if fill == float("-inf"):
            y = F.max_pool2d(x, k, s, p)
        else:
            w = torch.linspace(-1, 1, x.shape[1] * 3 * k * k).reshape(3, x.shape[1], k, k)
            y = F.conv2d(x, w, None, s, p)
        (y * y).sum().backward()
        parts = [r["units"]["windows"][i] for r in worlds]
        torch.testing.assert_close(torch.cat([q["y"] for q in parts], dim=-2), y.detach(),
                                   **UNIT_TOL)
        torch.testing.assert_close(torch.cat([q["dx"] for q in parts], dim=-2), x.grad,
                                   **UNIT_TOL)
    fwd, back = worlds[0]["units"]["stats"]
    assert fwd.exchanges >= len(WINDOWS) and back.exchanges >= len(WINDOWS)
    assert fwd.halo_rows > 0 and back.halo_rows > 0 and back.halo_bytes > 0


@pytest.mark.parametrize("kind", ["summed", "own"])
def test_row_gather_backwards(worlds, kind):
    """``summed``: each rank keeps its rows of a row-mixing map of the
    gathered map; the summed backward gives each its rows of the whole
    map's gradient. ``own``: every rank computes the same loss on the
    gathered map; each takes its rows of its own gradient (not summed)."""
    case = units_case()
    x = case["x"].clone().requires_grad_(True)
    if kind == "summed":
        y = torch.einsum("bchw,hk->bckw", x, case["mix"])
        (y * y).sum().backward()
    else:
        (x ** 3).sum().backward()
        for r in worlds:
            torch.testing.assert_close(r["units"]["gather"]["whole"], x.detach(), rtol=0, atol=0)
    got = torch.cat([r["units"]["gather"][f"{kind}_dx"] for r in worlds], dim=-2)
    torch.testing.assert_close(got, x.grad, **UNIT_TOL)


@pytest.mark.parametrize("which", [0, 1], ids=["dense_bias", "depthwise_s2"])
def test_tp_pair_matches_the_unsplit_conv(worlds, which):
    """A conv split over model 2 between the pair: the gathered output, the
    input's gradient (summed over the model group) and each rank's weight
    slice's gradient equal the unsplit conv's; the bias, added after the
    gather, takes the whole gradient on both ranks."""
    conv = units_case()["convs"][which]
    x = units_case()["x"][:, :conv.in_channels].clone().requires_grad_(True)
    y = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding, 1, conv.groups)
    (y * y).sum().backward()
    parts = [r["units"]["tp"][which] for r in worlds]
    for q in parts:
        torch.testing.assert_close(q["y"], y.detach(), **UNIT_TOL)
        torch.testing.assert_close(q["dx"], x.grad, **UNIT_TOL)
        if conv.bias is not None:
            torch.testing.assert_close(q["db"], conv.bias.grad, **UNIT_TOL)
    torch.testing.assert_close(torch.cat([q["dw"] for q in parts]), conv.weight.grad, **UNIT_TOL)


@pytest.mark.parametrize("run", [0, 1], ids=["sp2", "model2"])
def test_step_matches_jax(worlds, jax_step, run):
    before, jlb, (jp, jema, jtrace) = jax_step
    r = worlds[0]["runs"][run]
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
    assert r["step"] == 1 and r["again"]


@pytest.mark.parametrize("run", range(len(RUNS)))
def test_ranks_of_a_model_index_stay_identical(worlds, run):
    """The same bytes of the whole state within a ``model`` index (sp 2:
    both ranks; model 2: each rank holds other slices of the split convs,
    halved, every other tensor whole); the loss terms are the global ones
    on every rank; an sp run exchanged halos both ways."""
    rs = [w["runs"][run] for w in worlds]
    assert rs[0]["loss"] == rs[1]["loss"]
    by_index = {}
    for r in rs:
        by_index.setdefault(r["model_index"], set()).add(r["digest"])
    assert all(len(d) == 1 for d in by_index.values())
    if "model" in RUNS[run]["axes"]:
        assert len(by_index) == 2
        full = dict(build_model("yolov8n", nc=2).named_parameters())
        halved = [n for n, s in rs[0]["shapes"].items() if s != tuple(full[n].shape)]
        assert len(halved) > 20 and all(rs[0]["shapes"][n][0] * 2 == full[n].shape[0]
                                        for n in halved)
    else:
        (sp,) = rs[0]["sp"]
        assert sp["forward"]["halo_bytes"] > 0 and sp["backward"]["halo_bytes"] > 0


@pytest.fixture(scope="module")
def families_single():
    out = {}
    for name in FAMILIES:
        model = build_model(name, nc=2)
        init_weights(model, torch.Generator().manual_seed(0))
        before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        cfg = TTR.TrainConfig(**CFG)
        state, lb = TTR.train_step(model, cfg, TTR.init_state(model, cfg), make_batch())
        out[name] = ([float(v) for v in lb], before, port_dicts(state))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_families_on_sp_match_the_single_process_step(worlds, families_single, name):
    r = worlds[0]["runs"][2 + FAMILIES.index(name)]
    slb, before, (sp, sema, sbuf) = families_single[name]
    for t, s in zip(r["loss"], slb):
        assert abs(t - s) <= 1e-5 * abs(s), (r["loss"], slb)
    tp, tema, tbuf = r["dicts"]
    assert set(tbuf) == set(sbuf)
    tol = dict(frac=FAMILY_FRAC, floor=NOISE_FLOOR)
    assert within(tp, sp, before, what="params and stats", **tol) > 100
    assert within(tema, {k: sema[k] for k in tema}, before, what="ema", ulps=2, **tol) > 100
    assert within(tbuf, sbuf, None, what="momentum", **tol) > 100
