"""The process group of a data-parallel training run (in the JAX package
XLA's collectives do this work inside one program).

- :func:`spawn` starts one process (rank) per mesh entry with
  ``torch.multiprocessing``'s spawn context, joins them through a
  ``file://`` store in a temporary directory (no TCP port, so concurrent
  runs never collide on one), and returns each rank's result. A rank that
  raises, dies or outlives ``join_timeout`` fails the whole run, named in
  the error: there is no fallback.
- :func:`backend_for`: NCCL when the entries are distinct cards, gloo
  otherwise (the CPU, or one card named twice: NCCL refuses two ranks on
  one card; gloo on CUDA tensors runs ``all_reduce`` and ``broadcast``,
  all this package uses).
- :func:`all_reduce_sum` (in place, coalesced into one buffer per dtype)
  carries the gradients; :func:`all_reduce_sum_autograd` carries
  BatchNorm's sums with their gradient.
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
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import as_device

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


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum each tensor over the ranks, in place: the tensors of one dtype
    and device are flattened into one buffer, reduced in one call and
    copied back."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


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
    """Every rank's tensors set to rank ``src``'s, in place."""
    for t in tensors:
        dist.broadcast(t, src, group=group)


# ---- the global batch ----

_GLOBAL: list = []


@contextlib.contextmanager
def global_batch(group=None):
    """Inside, BatchNorm's training statistics and the detection loss's
    normalizer sum over the ranks of ``group`` (the default group)."""
    _GLOBAL.append(group)
    try:
        yield
    finally:
        _GLOBAL.pop()


def active_group():
    """-> (True, group) inside :func:`global_batch` with more than one
    rank, else (False, None)."""
    if _GLOBAL and world_size(_GLOBAL[-1]) > 1:
        return True, _GLOBAL[-1]
    return False, None
