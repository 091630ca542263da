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
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import commit_batch_stats
from ..parallel.distributed import all_reduce_sum, broadcast_, global_batch, world_size
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


def _step(model: nn.Module, cfg: TrainConfig, state: TrainState, batch: dict, group,
          timings: Optional[dict] = None) -> Tuple[TrainState, LossBreakdown]:
    """:func:`train_step`; with ``group`` (a process group of more than one
    rank, or the default group as ``dist.group.WORLD``) ``batch`` is this
    rank's shard of the global batch: BatchNorm and the loss normalizer
    take the global batch's sums, each rank's gradient (its share of the
    global loss's) is summed over the ranks before the update, and the
    loss terms returned are the global ones."""
    device = next(model.parameters()).device
    if batch["images"].shape[-1] == 3:
        batch = batch_to(batch, device)
    model.train()
    model.remat = cfg.remat
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    with (global_batch(group) if group is not None else contextlib.nullcontext()):
        lb = loss_of(model, cfg, batch)
        lb.total.backward()  # inside: remat recomputes its layers here
    lb = LossBreakdown(*(t.detach() for t in lb))
    if group is not None:
        grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
        if timings is not None:
            _sync(device)
            t0 = time.perf_counter()
        all_reduce_sum(grads, group)
        if timings is not None:
            _sync(device)
            timings.setdefault("all_reduce_s", []).append(time.perf_counter() - t0)
            timings["all_reduce_bytes"] = sum(g.numel() * g.element_size() for g in grads)
        lb = LossBreakdown(*all_reduce_sum([t.clone() for t in lb], group))
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


def shard_state(state: TrainState, mesh) -> TrainState:
    """Place the state on this process's device of ``mesh``
    (parallel/mesh.py; one rank per entry under a process group) and, with
    more than one rank, make every rank's state rank 0's (parameters,
    BatchNorm statistics, EMA, momentum buffers, step), so that the ranks
    start, and stay, equal. Updated in place and returned."""
    from ..parallel.mesh import local_shards, require_dp

    require_dp(mesh, "shard_state")
    shards = local_shards(mesh)
    if len(shards) != 1:
        raise ValueError("shard_state: a training process holds one device; run one rank per "
                         "mesh entry (parallel/distributed.py:spawn)")
    device = shards[0][1]
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
    return state


def make_sharded_train_step(model: nn.Module, cfg: TrainConfig, mesh,
                            timings: Optional[dict] = None):
    """-> ``step(state, batch) -> (state, loss terms)``: the train step of
    the global batch over ``mesh``'s ("dcn", "data") entries, one rank per
    entry (parallel/distributed.py:spawn; a one-entry mesh needs no process
    group), ``batch`` this rank's shard (parallel/mesh.py:device_put_batch
    or prefetch_to_device). The math is the JAX package's one global step:
    BatchNorm's statistics and the loss normalizer over the global batch,
    the gradient summed over the ranks, so that the optimizer, the EMA and
    the running statistics stay equal on every rank. With ``timings`` (a
    dict) the gradient's all-reduce is timed between two synchronizations
    (``all_reduce_s``, one entry a step, and ``all_reduce_bytes``)."""
    from ..parallel.mesh import batch_sharding, local_shards, require_dp

    require_dp(mesh, "make_sharded_train_step")
    shards = local_shards(mesh)
    if len(shards) != 1:
        raise ValueError("make_sharded_train_step: a training process holds one device; run "
                         "one rank per mesh entry (parallel/distributed.py:spawn)")
    if len(batch_sharding(mesh).devices) == 1:  # one device: the single-device step
        return lambda state, batch: train_step(model, cfg, state, batch)

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, LossBreakdown]:
        return _step(model, cfg, state, batch, torch.distributed.group.WORLD, timings)

    return step


def load_ema(state: TrainState, ema: Dict[str, torch.Tensor]) -> None:
    """Set the EMA from a state_dict (the parameters' entries of it)."""
    for n in state.ema:
        state.ema[n].copy_(torch.as_tensor(ema[n]))

