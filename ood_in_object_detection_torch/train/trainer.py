"""Training: the reference's three-group SGD with warmup, EMA, freeze and
remat (port of ood_in_object_detection_tpu/train/trainer.py).

Capability parity with the reference trainer (ultralytics/engine/trainer.py
and utils/torch_utils.py ModelEMA), as the JAX package has it:

- SGD momentum 0.937, Nesterov, weight decay 5e-4 on conv/linear weights
  only, in the reference's three parameter groups (trainer.py:796-846
  build_optimizer): biases (no decay, warmup from warmup_bias_lr), the
  other 1-D tensors such as BatchNorm scales (no decay), tensors of two or
  more dimensions (decay);
- a per-epoch staircase LR lr0 * lf(epoch), lf linear (or one-cycle cosine)
  (trainer.py:219-225), under a per-iteration warmup over nw =
  max(round(warmup_epochs * nb), 100) iterations (trainer.py:336,375-386):
  the bias LR falls from warmup_bias_lr to lr0 * lf(epoch), the others rise
  from 0 to it, momentum rises 0.8 -> 0.937; like the JAX package, every
  batch steps (the reference also ramps gradient accumulation in warmup);
- EMA decay 0.9999 ramped by d = decay * (1 - exp(-updates / 2000)), on the
  parameters alone: the EMA model carries the live BatchNorm statistics, as
  the JAX package's checkpoints pair ``ema_params`` with ``batch_stats``;
- f32 parameters with f32 or bf16 compute (the model's compute dtype):
  there is no loss scaling, as JAX trains bf16 without one.

``torch.optim.SGD(nesterov=True)`` with the three groups, whose ``lr`` and
``momentum`` are set from :func:`_hyper_at` before each step, has the update
rule of the JAX package's ``reference_sgd``: the decayed gradient enters the
momentum buffer, the step is ``lr * (g + momentum * buffer)``. The
schedule is computed in float32, as the JAX package computes it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import commit_batch_stats
from ..parallel import spatial
from ..parallel.distributed import (all_gather, all_reduce_sum, broadcast_, global_batch,
                                    world_size)
from .loss import LossBreakdown, detection_loss, v10_detection_loss

f32 = np.float32


@dataclasses.dataclass
class TrainConfig:
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    epochs: int = 100
    steps_per_epoch: int = 100
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    cos_lr: bool = False
    # recompute each layer's inside in the backward (torch.utils.checkpoint
    # at the per-layer boundaries, models/yolo.py): ~1 extra forward of
    # work for keeping only the layers' outputs
    remat: bool = False
    # parameters whose names start with one of these get no update and no
    # momentum buffer (reference custom_training.py:145-157's backbone
    # freeze); their BatchNorm statistics still move
    freeze_prefixes: tuple = ()


def _warmup_iters(cfg: TrainConfig) -> int:
    """nw = max(round(warmup_epochs * nb), 100) (reference trainer.py:336);
    -1 without warmup."""
    if cfg.warmup_epochs <= 0:
        return -1
    return max(round(cfg.warmup_epochs * cfg.steps_per_epoch), 100)


def _lf(cfg: TrainConfig, epoch) -> np.float32:
    """Per-epoch LR fraction (reference trainer.py:219-225): linear
    max(1 - e / epochs, 0) * (1 - lrf) + lrf, or one-cycle cosine 1 -> lrf."""
    e = f32(epoch)
    if cfg.cos_lr:
        return (((f32(1) - np.cos(e * f32(np.pi) / f32(cfg.epochs))) / f32(2))
                * f32(cfg.lrf - 1) + f32(1))
    return np.maximum(f32(1) - e / f32(cfg.epochs), f32(0)) * f32(1.0 - cfg.lrf) + f32(cfg.lrf)


def _hyper_at(cfg: TrainConfig, step) -> Tuple[np.float32, np.float32, np.float32]:
    """(lr_bias, lr_rest, momentum) at 0-based iteration ``step``: the
    reference's in-loop np.interp warmup (trainer.py:375-386) over the
    per-epoch staircase LR."""
    step = f32(step)
    epoch = np.floor(step / f32(cfg.steps_per_epoch))
    base = f32(cfg.lr0) * _lf(cfg, epoch)
    nw = _warmup_iters(cfg)
    if nw < 0:
        return base, base, f32(cfg.momentum)
    t = np.clip(step / f32(nw), f32(0), f32(1))
    lr_rest = t * base
    lr_bias = f32(cfg.warmup_bias_lr) + t * (base - f32(cfg.warmup_bias_lr))
    mom = f32(cfg.warmup_momentum) + t * f32(cfg.momentum - cfg.warmup_momentum)
    return lr_bias, lr_rest, mom


def lr_schedule(cfg: TrainConfig) -> Callable[[int], np.float32]:
    """The non-bias groups' LR at an iteration (for logging)."""
    return lambda step: _hyper_at(cfg, step)[1]


def backbone_freeze_prefixes(spec) -> tuple:
    """Parameter-name prefixes of the backbone: every layer before the first
    Upsample (the reference freezes model.model[:10] for v8); the JAX
    package's ``l{li}_`` prefixes are the port's ``model.{li}.``."""
    out = []
    for li, (_, _, mod, _) in enumerate(spec):
        if mod == "Upsample":
            break
        out.append(f"model.{li}.")
    return tuple(out)


def trained_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """The parameters the JAX package's tree holds: all but the frozen
    arange of the DFL conv (a constant there)."""
    return [(n, p) for n, p in model.named_parameters() if not n.endswith(".dfl.conv.weight")]


def param_groups(model: nn.Module, cfg: TrainConfig) -> List[dict]:
    """The reference's three groups (trainer.py:826-835): tensors of two or
    more dimensions that are not biases (decay), the other non-bias tensors
    (no decay), every tensor named ``bias``, BatchNorm's included (no decay,
    warmup from warmup_bias_lr); frozen ones in none."""
    decay, rest, bias = [], [], []
    for name, p in trained_parameters(model):
        if any(name.startswith(pre) for pre in cfg.freeze_prefixes):
            continue
        if name.rsplit(".", 1)[-1] == "bias":
            bias.append(p)
        elif p.ndim >= 2:
            decay.append(p)
        else:
            rest.append(p)
    return [dict(params=decay, weight_decay=cfg.weight_decay, bias_group=False),
            dict(params=rest, weight_decay=0.0, bias_group=False),
            dict(params=bias, weight_decay=0.0, bias_group=True)]


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.SGD:
    """Nesterov SGD over :func:`param_groups`; frozen parameters take no
    gradient."""
    for name, p in trained_parameters(model):
        p.requires_grad_(not any(name.startswith(pre) for pre in cfg.freeze_prefixes))
    return torch.optim.SGD(param_groups(model, cfg), lr=cfg.lr0, momentum=cfg.momentum,
                           nesterov=True)


@dataclasses.dataclass
class TrainState:
    """The model (the live parameters and BatchNorm statistics), the
    optimizer (its momentum buffers), the EMA of the parameters (name ->
    tensor) and the count of steps taken."""
    model: nn.Module
    optimizer: torch.optim.SGD
    ema: Dict[str, torch.Tensor]
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    @property
    def ema_params(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with the EMA in place of the parameters,
        the live BatchNorm statistics beside it."""
        sd = dict(self.model.state_dict())
        sd.update(self.ema)
        return sd


def init_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """A state around ``model``'s current weights: the EMA starts at them,
    the momentum buffers empty, step 0."""
    return TrainState(model=model, optimizer=make_optimizer(model, cfg),
                      ema={n: p.detach().clone() for n, p in trained_parameters(model)})


def batch_to(batch: dict, device, non_blocking: bool = False) -> dict:
    """A batch's images (B, H, W, 3) in [0, 1] as (B, 3, H, W) f32 and its
    padded ground truth as tensors, on ``device``."""
    def t(v):
        return torch.as_tensor(v).to(device, non_blocking=non_blocking)

    out = {k: t(batch[k]) for k in ("gt_labels", "gt_bboxes", "gt_mask")}
    out["images"] = t(batch["images"]).float().permute(0, 3, 1, 2)
    return out


def loss_of(model: nn.Module, cfg: TrainConfig, batch: dict) -> LossBreakdown:
    """The training forward and its loss; yolov10's dual head gives the dual
    loss (one2many third, one2one first: trainer.py:219-226)."""
    out = model(batch["images"])
    gains = dict(box_gain=cfg.box_gain, cls_gain=cfg.cls_gain, dfl_gain=cfg.dfl_gain)
    args = (batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"], model.nc)
    if len(out) == 3:
        return v10_detection_loss(out[2], out[0], *args, **gains)
    return detection_loss(out[0], *args, **gains)


def sgd_step(optimizer: torch.optim.SGD, cfg: TrainConfig, step: int) -> None:
    """The optimizer's step at 0-based iteration ``step``: each group's LR
    and momentum from :func:`_hyper_at`, then SGD on the gradients."""
    lr_bias, lr_rest, mom = _hyper_at(cfg, step)
    for g in optimizer.param_groups:
        g["lr"] = float(lr_bias if g["bias_group"] else lr_rest)
        g["momentum"] = float(mom)
    optimizer.step()


def ema_decay(cfg: TrainConfig, step: int) -> np.float32:
    """d = ema_decay * (1 - exp(-step / ema_tau)) in float32 (trainer.py:239)."""
    return f32(cfg.ema_decay) * (f32(1) - np.exp(-f32(step) / f32(cfg.ema_tau)))


def train_step(model: nn.Module, cfg: TrainConfig, state: TrainState,
               batch: dict) -> Tuple[TrainState, LossBreakdown]:
    """One optimization step on ``batch`` (images (B, H, W, 3) f32 in
    [0, 1] or already (B, 3, H, W) on the model's device through
    :func:`batch_to`; gt_labels (B, M), gt_bboxes (B, M, 4) xyxy pixels,
    gt_mask (B, M)). ``state`` is updated in place and returned with the
    loss terms (detached)."""
    return _step(model, cfg, state, batch, None)


def _step(model: nn.Module, cfg: TrainConfig, state: TrainState, batch: dict, groups,
          timings: Optional[dict] = None) -> Tuple[TrainState, LossBreakdown]:
    """:func:`train_step`; with ``groups`` (parallel/mesh.py:MeshGroups of a
    mesh of more than one rank) ``batch`` is this rank's part of the global
    batch (its batch shard's rows, on an ``sp`` axis its slab of their
    height): BatchNorm takes the global batch's sums over the ``reduce``
    axis, the loss normalizer over the ``batch`` axis; the halos and the
    gathered maps move over ``sp`` (parallel/spatial.py:RankShard), the
    split convs' channels over ``model``. Each rank's gradient (its share of
    the global loss's) is summed over the ``reduce`` axis before the update,
    and the loss terms returned are the global ones, each batch shard's
    counted once."""
    device = next(model.parameters()).device
    if batch["images"].shape[-1] == 3:
        batch = batch_to(batch, device)
    model.train()
    model.remat = cfg.remat
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    shard = None
    with contextlib.ExitStack() as ctx:
        if groups is not None:
            ctx.enter_context(global_batch(groups.reduce, groups.batch))
            if groups.sp.size > 1:
                shard = spatial.RankShard(groups.sp, groups.batch, device)
                ctx.enter_context(spatial.acting(shard))
        lb = loss_of(model, cfg, batch)
        lb.total.backward()  # inside: remat recomputes its layers here
    lb = LossBreakdown(*(t.detach() for t in lb))
    if groups is not None:
        grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
        if groups.reduce.size > 1:
            if timings is not None:
                _sync(device)
                t0 = time.perf_counter()
            all_reduce_sum(grads, groups.reduce.group)
            if timings is not None:
                _sync(device)
                timings.setdefault("all_reduce_s", []).append(time.perf_counter() - t0)
                timings["all_reduce_bytes"] = sum(g.numel() * g.element_size() for g in grads)
        if timings is not None and shard is not None:
            timings.setdefault("sp", []).append({"forward": dataclasses.asdict(shard.stats),
                                                 "backward": dataclasses.asdict(shard.stats_back)})
        if groups.batch.size > 1:
            lb = LossBreakdown(*all_reduce_sum([t.clone() for t in lb], groups.batch.group))
    sgd_step(opt, cfg, state.step)
    commit_batch_stats(model)
    state.step += 1
    d = ema_decay(cfg, state.step)
    with torch.no_grad():
        names = list(state.ema)
        params = dict(model.named_parameters())
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, [params[n].detach() for n in names], alpha=float(f32(1) - d))
    return state, lb


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of the state, in a fixed order: parameters and buffers,
    the EMA, the momentum buffers (of the parameters that have one)."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    out += [state.ema[n] for n in sorted(state.ema)]
    for g in state.optimizer.param_groups:
        for p in g["params"]:
            buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out.append(buf)
    return out


def _one_place(mesh, what: str):
    from ..parallel.mesh import local_shards

    shards = local_shards(mesh)
    if len(shards) != 1:
        raise ValueError(f"{what}: a training process holds one device; run one rank per mesh "
                         "entry (parallel/distributed.py:spawn)")
    return shards[0]


def split_convs(model: nn.Module) -> List[Tuple[str, nn.Conv2d]]:
    """(name, conv) of the convs split over a ``model`` axis
    (:func:`shard_state`), in module order."""
    return [(n, m) for n, m in model.named_modules() if getattr(m, "tp", None) is not None]


def _split_over_model(state: TrainState, axis) -> None:
    """Keep this rank's slice of the output channels of every conv that
    parallel/mesh.py:param_spec splits over ``axis`` (the ``model`` axis),
    of its EMA and of its momentum buffer; the conv computes that slice
    alone (models/layers.py:conv_in_dtype)."""
    from ..parallel.mesh import param_spec

    opt, k = state.optimizer, axis.index
    swapped = {}
    for name, conv in state.model.named_modules():
        if not (isinstance(conv, nn.Conv2d) and param_spec(name, conv.weight, axis.size)):
            continue
        if conv.groups > 1 and conv.groups % axis.size:
            raise ValueError(f"{name}: {conv.groups} groups do not split over a model axis "
                             f"of {axis.size}")
        old = conv.weight
        c = old.shape[0] // axis.size
        rows = slice(k * c, (k + 1) * c)
        conv.weight = nn.Parameter(old.detach()[rows].clone(), requires_grad=old.requires_grad)
        conv.tp = axis
        swapped[old] = (conv.weight, rows)
        if f"{name}.weight" in state.ema:
            state.ema[f"{name}.weight"] = state.ema[f"{name}.weight"][rows].clone()
    for g in opt.param_groups:
        g["params"] = [swapped[p][0] if p in swapped else p for p in g["params"]]
    for old, (new, rows) in swapped.items():
        st = opt.state.pop(old, None)
        if st is not None:
            opt.state[new] = {key: v[rows].clone() if isinstance(v, torch.Tensor) and
                              v.shape == old.shape else v for key, v in st.items()}


def shard_state(state: TrainState, mesh) -> TrainState:
    """Place the state on this process's device of ``mesh``
    (parallel/mesh.py; one rank per entry under a process group) and, with
    more than one rank, make every rank's state rank 0's (parameters,
    BatchNorm statistics, EMA, momentum buffers, step), so that the ranks
    start, and stay, equal. On a ``model`` axis above 1 each rank then keeps
    its slice of every conv weight that ``param_spec`` splits (the output
    channels), and of its EMA and momentum buffer; everything else stays
    whole on every rank, as the JAX package's ``shard_state`` places it.
    Updated in place and returned."""
    from ..parallel.mesh import mesh_groups

    device = _one_place(mesh, "shard_state").device
    state.model.to(device)
    for n in state.ema:
        state.ema[n] = state.ema[n].to(device)
    for st in state.optimizer.state.values():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                st[k] = v.to(device)
    if world_size() > 1:
        with torch.no_grad():
            broadcast_(state_tensors(state), src=0)
            step = torch.tensor([state.step], dtype=torch.int64, device=device)
            broadcast_([step], src=0)
            state.step = int(step.item())
        groups = mesh_groups(mesh)
        if groups.model.size > 1:
            _split_over_model(state, groups.model)
    return state


def gather_state(state: TrainState, mesh) -> Optional[TrainState]:
    """The whole state of a sharded run, in the single-process layout (the
    names and shapes of ``init_state``'s, every split conv's weight, EMA
    and momentum buffer gathered over the ``model`` axis), on the mesh's
    first rank; None on the others. Every rank calls it (the gathers are
    collective). The result is a TrainState of its own (a copy of the model
    on the rank's device), which ``core/checkpoint.py:save_checkpoint``
    writes as a single-process run's. The counterpart of the JAX package's
    globally addressable arrays."""
    from ..parallel.mesh import mesh_groups

    axis = mesh_groups(mesh).model if world_size() > 1 else None
    opt, split = state.optimizer, split_convs(state.model)
    parts = []  # (name, kind, this rank's slice), gathered in one call
    for name, conv in split:
        key = f"{name}.weight"
        parts.append((key, "param", conv.weight.detach()))
        if key in state.ema:
            parts.append((key, "ema", state.ema[key]))
        if "momentum_buffer" in opt.state.get(conv.weight, {}):
            parts.append((key, "momentum_buffer", opt.state[conv.weight]["momentum_buffer"]))
    whole: Dict[str, dict] = {}
    if parts:
        ranks = all_gather(torch.cat([v.reshape(-1) for _, _, v in parts]), axis)
        off = 0
        for key, kind, v in parts:
            whole.setdefault(key, {})[kind] = torch.cat(
                [r[off:off + v.numel()].view_as(v).to(v.dtype) for r in ranks])
            off += v.numel()
    if axis is not None and torch.distributed.get_rank() != 0:
        return None
    tps = [conv.__dict__.pop("tp") for _, conv in split]  # process groups do not copy
    try:
        model = copy.deepcopy(state.model)
    finally:
        for (_, conv), tp in zip(split, tps):
            conv.tp = tp
    for name, _ in split:
        conv = model.get_submodule(name)
        conv.weight = nn.Parameter(whole[f"{name}.weight"]["param"],
                                   requires_grad=conv.weight.requires_grad)
    live = {id(p): n for n, p in state.model.named_parameters()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    groups = [dict(g, params=[params[live[id(p)]] for p in g["params"]])
              for g in opt.param_groups]
    full_opt = type(opt)(groups, **opt.defaults)
    for p, st in opt.state.items():
        key = live[id(p)]
        full_opt.state[params[key]] = {
            k: whole[key][k] if key in whole and k in whole[key]
            else v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
    ema = {n: whole[n]["ema"] if n in whole else t.clone() for n, t in state.ema.items()}
    return TrainState(model=model, optimizer=full_opt, ema=ema, step=state.step)


def make_sharded_train_step(model: nn.Module, cfg: TrainConfig, mesh,
                            timings: Optional[dict] = None):
    """-> ``step(state, batch) -> (state, loss terms)``: the train step of
    the global batch over ``mesh``, one rank per entry
    (parallel/distributed.py:spawn; a one-entry mesh needs no process
    group), ``state`` placed by :func:`shard_state` and ``batch`` this
    rank's part (parallel/mesh.py:device_put_batch or prefetch_to_device):
    its batch shard's rows over ("dcn", "data"), its slab of their height
    over ``sp``; on ``model`` the split convs compute their slices. The
    math is the JAX package's one global step: BatchNorm's statistics and
    the loss normalizer over the global batch, the gradient summed over
    every rank of a ``model`` index, so that the optimizer, the EMA and the
    running statistics stay equal on the ranks of a ``model`` index (bit
    for bit). With ``timings`` (a dict) the gradient's all-reduce is timed
    between two synchronizations (``all_reduce_s``, one entry a step, and
    ``all_reduce_bytes``) and, on an ``sp`` axis, each step's halo and
    gather counts forward and backward are kept (``sp``,
    parallel/spatial.py:ShardStats)."""
    from ..parallel.mesh import mesh_groups

    _one_place(mesh, "make_sharded_train_step")
    if mesh.size == 1:  # one device: the single-device step
        return lambda state, batch: train_step(model, cfg, state, batch)
    groups = mesh_groups(mesh)

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, LossBreakdown]:
        return _step(model, cfg, state, batch, groups, timings)

    return step


def load_ema(state: TrainState, ema: Dict[str, torch.Tensor]) -> None:
    """Set the EMA from a state_dict (the parameters' entries of it)."""
    for n in state.ema:
        state.ema[n].copy_(torch.as_tensor(ema[n]))

