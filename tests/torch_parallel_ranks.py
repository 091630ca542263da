"""Rank functions of the port's parallel CPU tests (data, spatial and
tensor parallelism in training).

``parallel/distributed.py:spawn`` imports a rank function by name in each
fresh rank process, so these live in a module of their own that imports
torch, numpy and the port, and no JAX (each rank starts in ~2 s)."""

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ood_in_object_detection_torch.core.checkpoint import save_checkpoint
from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.models.layers import bn_train, conv_in_dtype
from ood_in_object_detection_torch.parallel import device_put_batch, make_mesh, prefetch_to_device
from ood_in_object_detection_torch.parallel import spatial
from ood_in_object_detection_torch.parallel.distributed import all_reduce_sum, global_batch
from ood_in_object_detection_torch.parallel.mesh import Axis, mesh_groups
from ood_in_object_detection_torch.train import trainer as TTR
from ood_in_object_detection_torch.utils.weights import numpy_state_dict


def fail_on(rank, world, bad):
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hang_on(rank, world, bad):
    """Rank ``bad`` never reaches the collective the others wait in."""
    if rank == bad:
        time.sleep(600)
    dist.all_reduce(torch.zeros(1))
    return rank


def reduce_mixed(rank, world):
    """all_reduce_sum on tensors of two dtypes and shapes."""
    ts = [torch.full((2, 3), float(rank + 1)), torch.arange(4, dtype=torch.int64) * (rank + 1),
          torch.tensor(0.5 * (rank + 1))]
    return [t.clone() for t in all_reduce_sum(ts)]


def bn_shard(rank, world, x, upstream, weight, bias, running):
    """bn_train on this rank's rows of ``x`` inside global_batch, the loss
    sum(y * upstream's rows) backward -> y, dL/dx, dL/dscale, dL/dbias (this
    rank's shares) and the pending running statistics."""
    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    bn = torch.nn.BatchNorm2d(x.shape[1], eps=1e-3)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(running[0])
        bn.running_var.copy_(running[1])
    xs = x[rows].clone().requires_grad_(True)
    axis = Axis(dist.group.WORLD, tuple(range(world)), rank)
    with global_batch(axis, axis):
        y = bn_train(bn, xs)
        (y * upstream[rows]).sum().backward()
    return dict(y=y.detach(), dx=xs.grad, dscale=bn.weight.grad, dbias=bn.bias.grad,
                pending=[t.clone() for t in bn.pending_stats])


def state_digest(state) -> str:
    """SHA-1 of every tensor of a TrainState and its step: equal on every
    rank when the ranks stayed equal."""
    h = hashlib.sha1(str(state.step).encode())
    for t in TTR.state_tensors(state):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def port_dicts(state):
    """(parameters with BatchNorm statistics, EMA, momentum buffers) as
    numpy state_dicts."""
    named = dict(state.model.named_parameters())
    buf = {n: state.optimizer.state[p]["momentum_buffer"].numpy().copy()
           for n, p in named.items() if p in state.optimizer.state}
    ema = {k: v.numpy().copy() for k, v in state.ema_params.items()}
    return numpy_state_dict(state.model), ema, buf


def sharded_steps(rank, world, cfgs, batch, name="yolov8n", nc=2, seed=0):
    """For each TrainConfig kwargs in ``cfgs``: a seeded ``name`` and one
    make_sharded_train_step step on this rank's shard of ``batch`` ->
    (loss terms, state digest, rank 0's state dicts)."""
    mesh = make_mesh(devices=["cpu"] * world)
    out = []
    for kw in cfgs:
        model = build_model(name, nc=nc)
        init_weights(model, torch.Generator().manual_seed(seed))
        cfg = TTR.TrainConfig(**kw)
        state = TTR.shard_state(TTR.init_state(model, cfg), mesh)
        step = TTR.make_sharded_train_step(model, cfg, mesh)
        state, lb = step(state, device_put_batch(batch, mesh)[0])
        out.append(dict(loss=[float(t) for t in lb], digest=state_digest(state), step=state.step,
                        dicts=port_dicts(state) if rank == 0 else None))
    return out


def bn_and_steps(rank, world, bn_args, cfgs, batch):
    """The two rank workloads of tests/test_torch_parallel_train.py in one
    process group."""
    return dict(bn=bn_shard(rank, world, *bn_args), steps=sharded_steps(rank, world, cfgs, batch))


def reduce_rows(rank, world, batch):
    """This rank's shard of ``batch`` through device_put_batch."""
    (shard,) = device_put_batch(batch, make_mesh(devices=["cpu"] * world))
    return {k: v.numpy() for k, v in shard.items()}


def mesh_step(rank, world, axes, cfg, batch, name="yolov8n", nc=2, seed=0, ckpt=None):
    """One make_sharded_train_step step of a seeded ``name`` on a mesh of
    ``world`` 'cpu' entries shaped by ``axes``, on this rank's part of
    ``batch`` -> loss terms, the state's digest, the rank's model index,
    the step's halo counts and, on rank 0, the gathered state's dicts (a
    checkpoint of it written at ``ckpt``) and a second gather's digest."""
    mesh = make_mesh(devices=["cpu"] * world, **axes)
    model = build_model(name, nc=nc)
    init_weights(model, torch.Generator().manual_seed(seed))
    tcfg = TTR.TrainConfig(**cfg)
    state = TTR.shard_state(TTR.init_state(model, tcfg), mesh)
    timings = {}
    step = TTR.make_sharded_train_step(model, tcfg, mesh, timings=timings)
    state, lb = step(state, device_put_batch(batch, mesh)[0])
    full, again = TTR.gather_state(state, mesh), TTR.gather_state(state, mesh)
    out = dict(loss=[float(t) for t in lb], digest=state_digest(state), step=state.step,
               model_index=mesh.place(rank).model, sp=timings.get("sp"),
               shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    if full is not None:
        out.update(dicts=port_dicts(full), again=state_digest(again) == state_digest(full))
        if ckpt:
            save_checkpoint(ckpt, full, {"name": "gathered"}, name)
    return out


def _units_window(shard, x, k, s, p, fill):
    """A conv (or, with fill -inf, a max-pool) of kernel k, stride s,
    padding p on this rank's rows of ``x`` through the halo window; its
    output rows, the input's gradient of sum(out * out's rows)."""
    h = x.shape[-2] // shard.axis.size
    xs = x[..., shard.rank * h:(shard.rank + 1) * h, :].clone().requires_grad_(True)
    win = shard.window(xs, k, s, p, fill)
    if fill == float("-inf"):
        y = F.max_pool2d(win, k, s, (0, p))
    else:
        w = torch.linspace(-1, 1, x.shape[1] * 3 * k * k).reshape(3, x.shape[1], k, k)
        y = F.conv2d(win, w, None, s, (0, p))
    (y * y).sum().backward()
    return dict(y=y.detach(), dx=xs.grad)


def _units_gather(shard, x, mix):
    """Both backwards of the row gather on this rank's rows of ``x``:
    ``summed`` under a row-mixing map whose output rows each rank keeps
    (loss sum(out^2) over its rows), ``own`` under a loss every rank
    computes whole (sum(whole^3))."""
    h = x.shape[-2] // shard.axis.size
    rows = slice(shard.rank * h, (shard.rank + 1) * h)
    xs = x[..., rows, :].clone().requires_grad_(True)
    whole, mine = shard.gather(xs, summed=True)
    y = torch.einsum("bchw,hk->bckw", whole, mix)[..., mine, :]
    (y * y).sum().backward()
    out = dict(summed_dx=xs.grad)
    xs = x[..., rows, :].clone().requires_grad_(True)
    whole = shard.gather(xs, summed=False)[0]
    (whole ** 3).sum().backward()
    out.update(whole=whole.detach(), own_dx=xs.grad)
    return out


def _units_tp(axis, x, convs):
    """Each conv of ``convs`` (nn.Conv2d) split over the ``model`` axis as
    shard_state splits it (this rank's output channels, ``conv.tp``),
    through models/layers.py:conv_in_dtype: its output, the input's
    gradient of sum(out^2) and its weight slice's and bias's gradients."""
    out = []
    for conv in convs:
        c = conv.out_channels // axis.size
        conv.weight = torch.nn.Parameter(conv.weight.detach()[axis.index * c:(axis.index + 1) * c])
        conv.tp = axis
        xs = x[:, :conv.in_channels].clone().requires_grad_(True)
        y = conv_in_dtype(conv, xs)
        (y * y).sum().backward()
        out.append(dict(y=y.detach(), dx=xs.grad, dw=conv.weight.grad,
                        db=None if conv.bias is None else conv.bias.grad))
    return out


def collective_units(rank, world, case):
    """parallel/distributed.py's collectives on two ranks: the halo window
    (k3/s1, k3/s2, k5 max-pool), both row gathers (an sp=2 mesh) and the
    tensor-parallel pair around a dense and a depthwise conv (a model=2
    mesh)."""
    sp = mesh_groups(make_mesh(sp=world, devices=["cpu"] * world))
    shard = spatial.RankShard(sp.sp, sp.batch, torch.device("cpu"))
    x = case["x"]
    out = dict(windows=[_units_window(shard, x, *kspf) for kspf in case["windows"]],
               gather=_units_gather(shard, x, case["mix"]))
    model = mesh_groups(make_mesh(model=world, devices=["cpu"] * world)).model
    out["tp"] = _units_tp(model, x, case["convs"])
    out["stats"] = (shard.stats, shard.stats_back)
    return out


def training_uses(rank, world, batch, images):
    """The four training uses of an ``sp`` and a ``model`` mesh of
    ``world`` 'cpu' entries: device_put_batch, prefetch_to_device,
    shard_state, make_sharded_train_step (one step) -> per mesh the
    images' shapes each place gets and the step's loss terms."""
    out = {}
    for axes in (dict(sp=world), dict(model=world)):
        mesh = make_mesh(devices=["cpu"] * world, **axes)
        (put,) = device_put_batch({"images": images}, mesh)
        (fed,) = prefetch_to_device(iter([batch]), mesh)
        model = build_model("yolov8n", nc=2)
        init_weights(model, torch.Generator().manual_seed(0))
        cfg = TTR.TrainConfig(warmup_epochs=0.0)
        state = TTR.shard_state(TTR.init_state(model, cfg), mesh)
        state, lb = TTR.make_sharded_train_step(model, cfg, mesh)(state, fed)
        out[tuple(axes)] = dict(put=tuple(put["images"].shape), fed=tuple(fed["images"].shape),
                                loss=[float(t) for t in lb], step=state.step)
    return out


def train_worlds(rank, world, runs, units=None):
    """One spawn's workloads: ``collective_units(case=units)`` when given,
    then :func:`mesh_step` for each kwargs of ``runs``."""
    out = dict(units=collective_units(rank, world, units) if units is not None else None)
    out["runs"] = [mesh_step(rank, world, **kw) for kw in runs]
    return out
