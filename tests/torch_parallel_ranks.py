"""Rank functions of the port's data-parallel CPU tests.

``parallel/distributed.py:spawn`` imports a rank function by name in each
fresh rank process, so these live in a module of their own that imports
torch, numpy and the port, and no JAX (each rank starts in ~2 s)."""

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ood_in_object_detection_torch.models import build_model, init_weights
from ood_in_object_detection_torch.models.layers import bn_train
from ood_in_object_detection_torch.parallel import device_put_batch, make_mesh
from ood_in_object_detection_torch.parallel.distributed import all_reduce_sum, global_batch
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
    with global_batch():
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
