"""Spatial and tensor parallelism in training on four gloo ranks on the CPU
(``train/trainer.py``: ``shard_state``, ``make_sharded_train_step``,
``gather_state``) against the port's single-process ``train_step`` on the
global batch, which tests/test_torch_train_step.py holds to the JAX
package's.

The setting is that file's: yolov8n at 64 px, nc 2, batch 2, warmup_epochs
0, seeded init. One spawn (four 'cpu' ranks, joined within 120 s) takes one
step on data 2 x sp 2, and one on sp 2 x model 2 with remat and a frozen
prefix (REMAT_FREEZE: the layers recomputed in the backward repeat their
halo exchanges and channel gathers on every rank in the same order; frozen
parameters take no gradient and no momentum buffer). After it: loss terms
within 1e-5 relative, every parameter, BatchNorm statistic, EMA value and
momentum buffer within ``within`` (1e-3 of the tensor's largest move plus
one or two float32 ulps; the slabs' convs and the split sums add in
another order); ranks of one ``model``
index bit-identical. ``gather_state`` on sp 2 x model 2 gives the
single-process layout: written by core/checkpoint.py:save_checkpoint and
restored into a fresh model by ``restore_train_state``, its names and
shapes are the single-process state's, its values within the same
tolerances, a second gather's bit-equal."""

import numpy as np
import pytest
import torch
from test_torch_parallel_train import REMAT_FREEZE
from test_torch_train_step import CFG, make_batch, port_dicts, within
from torch_threads import _two_threads  # noqa: F401 (autouse)

import torch_parallel_ranks as ranks
from ood_in_object_detection_torch.core.checkpoint import load_checkpoint, restore_train_state
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.parallel.distributed import spawn
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_torch.utils.weights import numpy_state_dict

JOIN_S = 120
RUNS = [dict(axes=dict(data=2, sp=2), cfg=CFG), dict(axes=dict(sp=2, model=2), cfg=REMAT_FREEZE)]
IDS = ["data2_sp2", "sp2_model2_remat_freeze"]
CKPT_RUN = 1


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gathered") / "sp2_model2")


@pytest.fixture(scope="module")
def worlds(ckpt):
    runs = [dict(kw, batch=make_batch(), ckpt=ckpt if i == CKPT_RUN else None)
            for i, kw in enumerate(RUNS)]
    return spawn(ranks.train_worlds, ["cpu"] * 4, args=(runs,), join_timeout=JOIN_S, threads=1)


@pytest.fixture(scope="module")
def single():
    """The single-process train_step on the global batch, per config of
    RUNS: (loss terms, state before, state dicts after)."""
    out = {}
    for cfg in (CFG, REMAT_FREEZE):
        tm = build_model("yolov8n", nc=2)
        init_weights(tm, torch.Generator().manual_seed(0))
        sd = numpy_state_dict(tm)
        tcfg = TTR.TrainConfig(**cfg)
        ts, lb = TTR.train_step(tm, tcfg, TTR.init_state(tm, tcfg), make_batch())
        out[id(cfg)] = ([float(v) for v in lb], sd, port_dicts(ts))
    return out


def _matches(dicts, loss, single_run):
    slb, before, (sp, sema, sbuf) = single_run
    for t, s in zip(loss, slb):
        assert abs(t - s) <= 1e-5 * abs(s), (loss, slb)
    tp, tema, tbuf = dicts
    assert set(tbuf) == set(sbuf) and set(tp) == set(sp)
    assert within(tp, sp, before, what="params and stats") > 100
    assert within(tema, {k: sema[k] for k in tema}, before, what="ema", ulps=2) > 100
    assert within(tbuf, sbuf, None, what="momentum") > 100


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_sharded_step_matches_single_process(worlds, single, run):
    r = worlds[0]["runs"][run]
    _matches(r["dicts"], r["loss"], single[id(RUNS[run]["cfg"])])
    assert r["step"] == 1 and r["again"]
    if RUNS[run]["cfg"] is REMAT_FREEZE:
        tp, before = r["dicts"][0], single[id(REMAT_FREEZE)][1]
        frozen = [k for k in tp if k.startswith(("model.0.conv", "model.1.conv"))]
        assert frozen and all(np.array_equal(tp[k], before[k]) for k in frozen)
        assert not any(k.startswith(("model.0.", "model.1.")) for k in r["dicts"][2])


@pytest.mark.parametrize("run", range(len(RUNS)), ids=IDS)
def test_ranks_of_a_model_index_stay_identical(worlds, run):
    rs = [w["runs"][run] for w in worlds]
    assert all(r["loss"] == rs[0]["loss"] for r in rs)
    by_index = {}
    for r in rs:
        by_index.setdefault(r["model_index"], set()).add(r["digest"])
    assert len(by_index) == RUNS[run]["axes"].get("model", 1)
    assert all(len(d) == 1 for d in by_index.values())
    for r in rs:  # every rank of these meshes holds a slab and exchanged halos both ways
        (sp,) = r["sp"]
        assert sp["forward"]["halo_rows"] > 0 and sp["backward"]["halo_rows"] > 0


def test_gathered_state_round_trips_through_a_checkpoint(worlds, single, ckpt):
    """The checkpoint of sp 2 x model 2's gathered state (REMAT_FREEZE, so
    the optimizer's groups leave the frozen tensors out): the EMA weights
    as load_checkpoint gives them, and the whole TrainState as
    restore_train_state rebuilds it in a fresh model (parameters, BatchNorm
    statistics, EMA, momentum buffers by the optimizer's own state_dict
    order), against the single-process state."""
    sd, meta = load_checkpoint(ckpt)
    assert meta["model_name"] == "yolov8n" and meta["nc"] == 2
    model = build_model("yolov8n", nc=2)
    full = dict(model.state_dict())
    assert sd.keys() == full.keys() and all(sd[k].shape == full[k].shape for k in sd)
    cfg = RUNS[CKPT_RUN]["cfg"]
    state, _ = restore_train_state(ckpt, model, TTR.TrainConfig(**cfg))
    assert state.step == 1
    got = port_dicts(state)
    _matches(got, worlds[0]["runs"][CKPT_RUN]["loss"], single[id(cfg)])
    np.testing.assert_array_equal(
        np.concatenate([v.ravel() for v in got[1].values()]),
        np.concatenate([sd[k].numpy().ravel() for k in got[1]]))
