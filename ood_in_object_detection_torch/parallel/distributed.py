"""The process group of a training run over a mesh (in the JAX package
XLA's collectives do this work inside one program).

- :func:`spawn` starts one process (rank) per mesh entry with
  ``torch.multiprocessing``'s spawn context, joins them through a
  ``file://`` store in a temporary directory (no TCP port, so concurrent
  runs never collide on one), and returns each rank's result. A rank that
  raises, dies or outlives ``join_timeout`` fails the whole run, named in
  the error: there is no fallback.
- :func:`backend_for`: NCCL when the entries are distinct cards, gloo
  otherwise (the CPU, or one card named twice: NCCL refuses two ranks on
  one card). gloo runs ``all_reduce`` and ``broadcast`` on a card's
  tensors itself; the point-to-point and ``all_gather`` calls below stage
  a card's tensors through pinned host buffers on every call under gloo
  (the one route there), and hand them to NCCL as they are.
- :func:`all_reduce_sum` (in place, coalesced into one buffer per dtype)
  carries the gradients; :func:`all_reduce_sum_autograd` carries
  BatchNorm's sums with their gradient.
- Collectives with gradients over an axis of the mesh
  (parallel/mesh.py:Axis), each a ``torch.autograd.Function`` that every
  rank of the axis issues in the same order, forward and backward:
  :func:`halo_window` (the rows a conv or pool window reads from the
  neighbours; the backward returns each halo row's gradient to its owner,
  which adds it into its rows), :func:`row_gather` (a map's rows from every
  shard; the backward either sums the group's gradients and keeps this
  rank's rows, or keeps this rank's rows of its own gradient) and the
  tensor-parallel pair :func:`to_model` (identity; the backward sums over
  the ``model`` group) and :func:`gather_channels` (the channel slices of
  the ``model`` group; the backward keeps this rank's slice).
- :func:`global_batch` marks the code whose BatchNorm statistics
  (models/layers.py:bn_train) and loss normalizer (train/loss.py) are
  those of the global batch: the sharded train step's forward and
  backward.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis, as_device

# seconds a collective may wait for the other ranks (rank 0's validation
# runs while the others wait in their next step's first collective)
PG_TIMEOUT_S = 1800.0


def backend_for(devices: Sequence) -> str:
    """'nccl' when every entry is a distinct card, else 'gloo'."""
    devs = [d if isinstance(d, torch.device) else as_device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def _fn_ref(fn: Callable) -> tuple:
    """(module, qualified name) of a module-level function, ``__main__``
    resolved to the name it was run under: ``python -m pkg.mod`` gives
    'pkg.mod', ``python script.py`` 'script' (its directory is the first
    entry of sys.path, which the ranks inherit)."""
    mod = fn.__module__
    if mod == "__main__":
        main = sys.modules["__main__"]
        spec = getattr(main, "__spec__", None)
        if spec is not None:
            mod = spec.name
        elif getattr(main, "__file__", None) and \
                os.path.dirname(os.path.abspath(main.__file__)) in map(os.path.abspath, sys.path):
            mod = os.path.splitext(os.path.basename(main.__file__))[0]
        else:
            raise ValueError("spawn: the ranks cannot import a function of this __main__; "
                             "put it in a module")
    return mod, fn.__qualname__


def _rank_main(rank: int, world: int, ref: tuple, args: tuple, kwargs: dict, devices: list,
               store: str, backend: str, threads: Optional[int], tf32: tuple,
               results) -> None:
    try:
        dev = devices[rank]
        if threads:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            fn = getattr(importlib.import_module(ref[0]), ref[1])
            out = fn(rank, world, *args, **kwargs)
        finally:
            dist.destroy_process_group()
        # pickled here by value: the queue's own pickler would hand tensors
        # over as shared memory of a process that is about to exit
        results.put(("ok", rank, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the run
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        results.close()
        results.join_thread()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(fn: Callable, devices: Sequence, args: tuple = (), kwargs: Optional[dict] = None, *,
          join_timeout: Optional[float] = None, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world, *args, **kwargs)`` in one fresh process per
    entry of ``devices`` (a rank's device is ``devices[rank]``, made current
    there), inside a process group of them all -> the ranks' return values,
    in rank order (they must pickle). ``fn`` must be a module-level
    function. Each rank sets ``threads`` intra-op threads (by default, when
    the entries are CPUs, as many as this process has) and, on a card, this
    process's TF32 settings for matmuls and cuDNN (a spawned process would
    start from PyTorch's defaults). A rank that raises or exits early, or a
    run past ``join_timeout`` seconds, stops every rank and raises
    RuntimeError naming the rank."""
    devs = [as_device(d) for d in devices]
    world = len(devs)
    if world < 1:
        raise ValueError("spawn: no devices")
    if threads is None and all(d.type == "cpu" for d in devs):
        threads = torch.get_num_threads()
    backend = backend_for(devs)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ood_torch_pg_")
    store = os.path.join(tmp, "store")
    ref = _fn_ref(fn)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, ref, tuple(args), dict(kwargs or {}), devs, store,
                               backend, threads, tf32, results), daemon=False)
             for r in range(world)]
    out: dict = {}
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                kind, rank, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and not p.is_alive() and p.exitcode != 0:
                        raise RuntimeError(f"rank {r} of {world} ({devs[r]}) exited with code "
                                           f"{p.exitcode} before reporting")
                if deadline is not None and time.monotonic() > deadline:
                    late = [r for r in range(world) if r not in out]
                    raise RuntimeError(f"rank {late[0]} of {world} ({devs[late[0]]}) did not "
                                       f"finish within {join_timeout:.0f} s (ranks {late} "
                                       "still running: a hung collective?)")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} ({devs[rank]}) failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(30)
        return [out[r] for r in range(world)]
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---- collectives ----

def world_size(group=None) -> int:
    """The size of ``group`` (the default group), 1 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _coalesced(tensors: List[torch.Tensor], collective: Callable) -> List[torch.Tensor]:
    """``collective`` (in place on one tensor) on every tensor, in place:
    the tensors of one dtype and device flattened into one buffer, one call
    a buffer, copied back."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum each tensor over the ranks, in place (one call a dtype)."""
    return _coalesced(tensors, lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; each rank's dL/dx is the sum of
    every rank's dL/dy (every rank's loss reads the same y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def broadcast_(tensors: List[torch.Tensor], src: int = 0, group=None) -> None:
    """Every rank's tensors set to rank ``src``'s, in place (one call a
    dtype)."""
    _coalesced(tensors, lambda t: dist.broadcast(t, src, group=group))


# ---- collectives with gradients over a mesh axis ----

def _staged(axis: Axis) -> bool:
    """gloo moves host memory: under it a card's tensors go through pinned
    host buffers (on every call); NCCL takes them on the card."""
    return dist.get_backend(axis.group) == "gloo"


def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """``t`` as the backend takes it: a pinned host copy of a card's tensor
    under gloo, else ``t`` (contiguous)."""
    if staged and t.is_cuda:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t.contiguous()


def _wire_empty(shape, dtype, device: torch.device, staged: bool) -> torch.Tensor:
    if staged and device.type == "cuda":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def exchange(axis: Axis, sends, recvs, device: torch.device) -> List[torch.Tensor]:
    """Point-to-point over ``axis``: ``sends`` [(peer index, tensor)],
    ``recvs`` [(peer index, shape, dtype)] -> the received tensors on
    ``device``, in the order of ``recvs``. A pair of ranks lists its
    messages to each other in the same order; a rank with none issues
    nothing."""
    staged = _staged(axis)
    ops, bufs = [], []
    for j, t in sends:
        ops.append(dist.P2POp(dist.isend, _wire(t, staged), axis.ranks[j], axis.group))
    for j, shape, dtype in recvs:
        bufs.append(_wire_empty(shape, dtype, device, staged))
        ops.append(dist.P2POp(dist.irecv, bufs[-1], axis.ranks[j], axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(device) for b in bufs]


def all_gather(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank's ``x`` (all of one shape), in axis order, on x's device."""
    staged = _staged(axis)
    outs = [_wire_empty(x.shape, x.dtype, x.device, staged) for _ in range(axis.size)]
    dist.all_gather(outs, _wire(x, staged), group=axis.group)
    return [o.to(x.device) for o in outs]


def row_layout(axis: Axis, height: int, device: torch.device) -> Tuple[List[int], List[int]]:
    """(first rows, heights) of every rank's part of a map split by rows
    over ``axis``, given this rank's ``height``."""
    t = torch.tensor([height], dtype=torch.int64)
    heights = [int(h) for h in all_gather(t if _staged(axis) else t.to(device), axis)]
    starts = [sum(heights[:j]) for j in range(len(heights))]
    return starts, heights


class HaloPlan(NamedTuple):
    """One rank's window of global rows [lo, hi) of a map split by rows:
    its own rows ``own`` (global [a, b), possibly empty) starting at global
    row ``start``, the rows it takes from other ranks ``recv`` [(peer
    index, a, b)], the rows of its own the others take ``send`` [(peer
    index, a, b)] (all global, ascending by peer), the map's ``height`` and
    the ``fill`` of the rows past its edges."""
    lo: int
    hi: int
    start: int
    own: Tuple[int, int]
    recv: Tuple[Tuple[int, int, int], ...]
    send: Tuple[Tuple[int, int, int], ...]
    height: int
    fill: Optional[float]


def _with_rows(x: torch.Tensor, n: int) -> list:
    shape = list(x.shape)
    shape[-2] = n
    return shape


def _timed(stats, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    stats.wait_s += time.perf_counter() - t0
    return out


class _HaloWindow(torch.autograd.Function):
    """The rows of a window (:class:`HaloPlan`) from their owners, the image
    edge filled; backward: each halo row's gradient back to its owner,
    which adds it into its rows (a row several windows read sums them)."""

    @staticmethod
    def forward(ctx, x, plan: HaloPlan, axis: Axis, stats, stats_back):
        ctx.plan, ctx.axis, ctx.stats_back, ctx.shape = plan, axis, stats_back, x.shape
        s0 = plan.start
        got = _timed(stats, exchange, axis,
                     [(j, x[..., a - s0:b - s0, :]) for j, a, b in plan.send],
                     [(j, _with_rows(x, b - a), x.dtype) for j, a, b in plan.recv], x.device)
        stats.exchanges += 1
        stats.halo_rows += sum(b - a for _, a, b in plan.recv)
        stats.halo_bytes += sum(t.numel() * t.element_size() for t in got)
        pieces = []
        if plan.lo < 0:
            pieces.append(x.new_full(_with_rows(x, -plan.lo), plan.fill))
        received = iter(got)
        for j, a, b in sorted([(axis.index, *plan.own)] + list(plan.recv)):
            if j == axis.index:
                if a < b:
                    pieces.append(x[..., a - s0:b - s0, :])
            else:
                pieces.append(next(received))
        if plan.hi > plan.height:
            pieces.append(x.new_full(_with_rows(x, plan.hi - plan.height), plan.fill))
        return pieces[0].clone() if len(pieces) == 1 else torch.cat(pieces, dim=-2)

    @staticmethod
    def backward(ctx, g):
        plan, axis, stats = ctx.plan, ctx.axis, ctx.stats_back
        s0, lo = plan.start, plan.lo
        got = _timed(stats, exchange, axis,
                     [(j, g[..., a - lo:b - lo, :]) for j, a, b in plan.recv],
                     [(j, _with_rows(g, b - a), g.dtype) for j, a, b in plan.send], g.device)
        stats.exchanges += 1
        stats.halo_rows += sum(b - a for _, a, b in plan.send)
        stats.halo_bytes += sum(t.numel() * t.element_size() for t in got)
        dx = g.new_zeros(ctx.shape)
        a, b = plan.own
        if a < b:
            dx[..., a - s0:b - s0, :] += g[..., a - lo:b - lo, :]
        for (_, a, b), t in zip(plan.send, got):
            dx[..., a - s0:b - s0, :] += t
        return dx, None, None, None, None


def halo_window(x: torch.Tensor, plan: HaloPlan, axis: Axis, stats, stats_back) -> torch.Tensor:
    """:class:`_HaloWindow`; ``stats`` and ``stats_back`` (parallel/
    spatial.py:ShardStats) count the forward's and the backward's
    exchanges, rows and bytes taken from other ranks and seconds in them."""
    return _HaloWindow.apply(x, plan, axis, stats, stats_back)


class _RowGather(torch.autograd.Function):
    """The whole map from every rank's rows (``heights``, in axis order;
    padded to the tallest for the gather). Backward, ``summed``: the
    group's gradients summed, then this rank's rows (every rank keeps other
    rows of what it computes from the map); else this rank's rows of its
    own gradient (every rank computes the same from the map)."""

    @staticmethod
    def forward(ctx, x, axis: Axis, heights, summed: bool, stats, stats_back):
        ctx.axis, ctx.summed, ctx.stats_back = axis, summed, stats_back
        ctx.rows = (sum(heights[:axis.index]), sum(heights[:axis.index + 1]))
        tall = max(heights)
        pad = x if x.shape[-2] == tall else torch.cat(
            [x, x.new_zeros(_with_rows(x, tall - x.shape[-2]))], dim=-2)
        parts = _timed(stats, all_gather, pad, axis)
        stats.exchanges += 1
        stats.gather_rows += sum(heights) - x.shape[-2]
        stats.gather_bytes += (sum(heights) - x.shape[-2]) * x[..., :1, :].numel() * \
            x.element_size()
        return torch.cat([p[..., :h, :] for p, h in zip(parts, heights)], dim=-2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        if ctx.summed:
            g = g.contiguous().clone()
            _timed(ctx.stats_back, dist.all_reduce, g, dist.ReduceOp.SUM, ctx.axis.group)
            ctx.stats_back.exchanges += 1
            ctx.stats_back.gather_rows += g.shape[-2]
            ctx.stats_back.gather_bytes += g.numel() * g.element_size()
        return g[..., a:b, :].contiguous(), None, None, None, None, None


def row_gather(x: torch.Tensor, axis: Axis, heights, summed: bool, stats,
               stats_back) -> torch.Tensor:
    """:class:`_RowGather`, counted as :func:`halo_window` counts."""
    return _RowGather.apply(x, axis, list(heights), summed, stats, stats_back)


class _ToModel(torch.autograd.Function):
    """Identity; backward: the ``model`` group's gradients summed (each
    rank's holds what its slice of a split conv reads from the input)."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.axis.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The ``model`` group's equal channel slices, in axis order;
    backward: this rank's slice of its gradient (everything after the
    gather is replicated, so every rank's gradient is the whole one)."""

    @staticmethod
    def forward(ctx, y, axis: Axis):
        ctx.axis, ctx.c = axis, y.shape[1]
        return torch.cat(all_gather(y.contiguous(), axis), dim=1)

    @staticmethod
    def backward(ctx, g):
        i, c = ctx.axis.index, ctx.c
        return g[:, i * c:(i + 1) * c].contiguous(), None


def to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The input side of a split conv (:class:`_ToModel`)."""
    return _ToModel.apply(x, axis)


def gather_channels(y: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The output side of a split conv (:class:`_GatherChannels`)."""
    return _GatherChannels.apply(y, axis)


# ---- the global batch ----

_GLOBAL: list = []


@contextlib.contextmanager
def global_batch(reduce: Axis, batch: Axis):
    """Inside, BatchNorm's training statistics sum over the ranks of
    ``reduce`` and the detection loss's normalizer over those of ``batch``
    (one rank a batch shard)."""
    _GLOBAL.append((reduce, batch))
    try:
        yield
    finally:
        _GLOBAL.pop()


def bn_axis() -> Optional[Axis]:
    """The axis BatchNorm's sums span inside :func:`global_batch`, None
    outside it or on one rank."""
    if _GLOBAL and _GLOBAL[-1][0].size > 1:
        return _GLOBAL[-1][0]
    return None


def loss_axis() -> Optional[Axis]:
    """The axis the loss normalizer spans inside :func:`global_batch`, None
    outside it or on one rank."""
    if _GLOBAL and _GLOBAL[-1][1].size > 1:
        return _GLOBAL[-1][1]
    return None
