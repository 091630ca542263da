"""Spatial parallelism: the ``sp`` shards of one batch shard (port of the
JAX package's ``sp`` mesh axis, engine.py:predict_sharded,
parallel/mesh.py and train/trainer.py's sharded step, where XLA's SPMD
partitioner splits the image height and inserts a halo collective-permute
at every conv and pool wider than 1).

At inference the halos are exchanged by hand. One host thread per ``sp``
entry runs the unchanged model forward on its rows of the image; the layers
that read across rows (models/layers.py) ask the thread's :class:`Shard` for
what they need, and the shards meet at a barrier per exchange:

- :meth:`Shard.window`: the rows a conv or pool of kernel k, stride s and
  padding p reads for this shard's output rows, the neighbours' edge rows
  included (from as many shards away as the halo spans) and the image edge
  filled (zeros for a conv, -inf for a max-pool, nothing for a VALID pool);
- :meth:`Shard.gather`: the whole map (an attention block reads every row);
- :meth:`Shard.whole_map`: run a block on a gathered map, the rules off.

Row ranges are never assumed equal: at every exchange each shard posts its
local map, so every shard sees every shard's height, hence its own global
rows and the map's height. An output row belongs to the shard that owns the
input row at its anchor (row r of a stride-s op to the owner of input row
r s), so the outputs of two ops on one map line up for a concat or a sum.
The image splits into equal slabs of a whole number of rows at the model's
largest stride (:func:`row_spans`), so every map's rows stay aligned.

In training each shard is a rank of its own (one process a mesh entry,
parallel/distributed.py:spawn): :class:`RankShard` answers the same
requests through collectives with gradients over the rank's ``sp`` group
(parallel/distributed.py: ``halo_window``, ``row_gather``), so the same
layer rules run forward and backward; the halo rows' gradients return to
their owners, and a gathered map's gradient comes back summed (attention,
which keeps other rows on every rank) or as this rank's rows of its own
(the detection loss, which every rank computes whole).

Streams: every shard issues its work on the caller's current stream of each
device of its group (one stream per device, whichever threads use it). A
neighbour's rows are copied after the barrier, that is after the producer
enqueued the kernels that wrote them, on the same stream, so the copy runs
after them without an event; a map a shard posted stays referenced until the
copy is enqueued, so the allocator cannot hand its memory to a later kernel
first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import time
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import distributed as D

# rows of image a shard other than the first also takes from above its own:
# the fused stem's receptive field reaches 3 rows up, and 4 keep its input
# height a multiple of 4 (ops/stem.py); the shard drops the stem's first
# output row, which the kernel's own zero padding spoils
STEM_OVERLAP = 4
# seconds a shard waits at an exchange before the group is given up
BARRIER_TIMEOUT_S = 600.0

_LOCAL = threading.local()


def current() -> Optional["Shard"]:
    """The shard whose forward this thread runs, or None (no ``sp`` split,
    or a block running on a whole map)."""
    return getattr(_LOCAL, "shard", None)


def row_spans(height: int, sp: int, stride: int) -> List[Tuple[int, int]]:
    """Each shard's image rows [lo, hi): ``sp`` equal slabs of a whole
    number of rows at the model's largest ``stride``; a height that does
    not split so raises ValueError naming the heights that do."""
    if sp < 1 or height % (sp * stride):
        raise ValueError(
            f"an image height of {height} does not split over sp={sp} into slabs of a whole "
            f"number of rows at stride {stride}: the height must be a multiple of "
            f"{sp * stride} (e.g. {sp * stride * max(1, height // (sp * stride))})")
    h = height // sp
    return [(i * h, (i + 1) * h) for i in range(sp)]


def window_rows(ia: int, h: int, height: int, rank: int, k: int, s: int, p: int,
                fill: Optional[float]) -> Tuple[int, int]:
    """The global input rows [lo, hi) that an op of kernel height ``k``,
    stride ``s`` and padding ``p`` reads for the output rows of the shard
    ``rank`` holding rows [ia, ia + h) of a map of ``height`` rows. Output
    row r belongs to the owner of input row r s; it reads rows [r s - p,
    r s - p + k), those past the map's edges ``fill`` (None: the op reads
    none, VALID, and a window past them raises ValueError)."""
    ib = ia + h
    h_out = (height + 2 * p - k) // s + 1
    oa, ob = -(-ia // s), min(-(-ib // s), h_out)
    if ob <= oa:
        raise ValueError(f"sp shard {rank}: rows [{ia}, {ib}) of a map of {height} "
                         f"leave no output row of a k{k}/s{s} op")
    lo, hi = oa * s - p, (ob - 1) * s - p + k
    if (lo < 0 or hi > height) and fill is None:
        raise ValueError(f"sp shard {rank}: a VALID op reads rows [{lo}, {hi}) of "
                         f"a map of {height}")
    return lo, hi


class ShardFailed(RuntimeError):
    """A shard of an ``sp`` group raised; the others were stopped."""


@dataclasses.dataclass
class ShardStats:
    """What one shard did in one run: exchanges, rows and bytes taken from
    other shards (halos and gathers), host seconds waiting at the barrier."""
    exchanges: int = 0
    halo_rows: int = 0
    halo_bytes: int = 0
    gather_rows: int = 0
    gather_bytes: int = 0
    wait_s: float = 0.0


class SpGroup:
    """The ``sp`` entries of one batch shard, in height order: one thread a
    shard, a barrier per exchange (BARRIER_TIMEOUT_S at most; a shard that
    raises breaks it, so the others stop at once)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.barrier = threading.Barrier(self.size, timeout=BARRIER_TIMEOUT_S)
        self._slots: List[list] = [[None] * self.size, [None] * self.size]
        self.stats = [ShardStats() for _ in self.devices]


class Shard:
    """Shard ``rank`` of ``group``: its device, its place in the group and
    ``overlap``, the rows of image above its own that its input also holds
    (:data:`STEM_OVERLAP` for every shard but the first)."""

    def __init__(self, group: SpGroup, rank: int, overlap: int = 0):
        self.group, self.rank, self.overlap = group, rank, overlap
        self.device = group.devices[rank]
        self.stats = group.stats[rank]
        self._gen = 0

    # -- the collective --------------------------------------------------

    def _post(self, x: torch.Tensor) -> list:
        """Post this shard's map, wait for every shard's -> all the maps."""
        g = self.group
        slot = g._slots[self._gen % 2]  # two slots: a shard can run one exchange ahead
        self._gen += 1
        slot[self.rank] = x
        t0 = time.perf_counter()
        try:
            g.barrier.wait()
        except threading.BrokenBarrierError:
            raise ShardFailed(f"sp shard {self.rank}: another shard of the group failed") \
                from None
        self.stats.wait_s += time.perf_counter() - t0
        self.stats.exchanges += 1
        return list(slot)

    def _layout(self, parts) -> Tuple[List[int], int]:
        starts, h = [], 0
        for p in parts:
            starts.append(h)
            h += p.shape[-2]
        return starts, h

    def _rows(self, parts, starts, height, lo, hi, fill) -> Tuple[torch.Tensor, int, int]:
        """Global rows [lo, hi) of the posted map on this device, rows past
        the map's edges ``fill``; -> (the rows, rows and bytes taken from
        other shards)."""
        x = parts[self.rank]
        pieces, taken, nbytes = [], 0, 0

        def edge(n):
            shape = list(x.shape)
            shape[-2] = n
            return x.new_full(shape, fill)

        if lo < 0:
            pieces.append(edge(-lo))
        for j, part in enumerate(parts):
            a, b = max(lo, starts[j]), min(hi, starts[j] + part.shape[-2])
            if a >= b:
                continue
            rows = part[..., a - starts[j]:b - starts[j], :]
            if j != self.rank:
                rows = rows.to(self.device)
                taken += b - a
                nbytes += rows.numel() * rows.element_size()
            pieces.append(rows)
        if hi > height:
            pieces.append(edge(hi - height))
        return (pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-2)), taken, nbytes

    def _halo_rows(self, parts, starts, height, lo, hi, fill) -> torch.Tensor:
        rows, taken, nbytes = self._rows(parts, starts, height, lo, hi, fill)
        self.stats.halo_rows += taken
        self.stats.halo_bytes += nbytes
        return rows

    # -- what the layers ask for -----------------------------------------

    def window(self, x: torch.Tensor, k: int, s: int, p: int,
               fill: Optional[float]) -> torch.Tensor:
        """The input rows that an op of kernel height ``k``, stride ``s``
        and padding ``p`` reads for this shard's output rows, as one map:
        run the op on it with height padding 0. Output row r belongs to the
        owner of input row r s; it reads rows [r s - p, r s - p + k), those
        past the map's edges ``fill`` (None: the op reads none, VALID)."""
        parts = self._post(x)
        starts, height = self._layout(parts)
        lo, hi = window_rows(starts[self.rank], x.shape[-2], height, self.rank, k, s, p, fill)
        return self._halo_rows(parts, starts, height, lo, hi, fill)

    def gather(self, x: torch.Tensor) -> Tuple[torch.Tensor, slice]:
        """The whole map on this device, and this shard's rows of it."""
        parts = self._post(x)
        starts, height = self._layout(parts)
        whole, taken, nbytes = self._rows(parts, starts, height, 0, height, 0.0)
        self.stats.gather_rows += taken
        self.stats.gather_bytes += nbytes
        ia = starts[self.rank]
        return whole, slice(ia, ia + x.shape[-2])

    def layout(self, x: torch.Tensor) -> Tuple[List[int], List[int]]:
        """(first rows, heights) of every shard's part of the map."""
        parts = self._post(x)
        return self._layout(parts)[0], [p.shape[-2] for p in parts]

    @contextlib.contextmanager
    def whole_map(self):
        """Layers inside run on a whole (gathered) map: no rule applies."""
        _LOCAL.shard = None
        try:
            yield
        finally:
            _LOCAL.shard = self

    def on_whole_map(self, fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
        """``fn`` on the gathered map, this shard's rows of its output."""
        whole, rows = self.gather(x)
        with self.whole_map():
            y = fn(whole)
        return y[..., rows, :]


class RankShard:
    """The ``sp`` shard a training rank holds (its slab of every map's rows
    over its mesh's ``sp`` group, parallel/mesh.py:MeshGroups): the
    requests of :class:`Shard` answered by collectives with gradients
    (parallel/distributed.py). ``batch`` is the rank's batch axis: a block
    run on a gathered map takes BatchNorm's statistics over it (each rank
    of the ``sp`` group holds the whole map then). ``stats`` and
    ``stats_back`` count the forward's and the backward's exchanges (a
    layer recomputed under remat counts again)."""

    overlap = 0  # the training forward runs no fused stem

    def __init__(self, axis, batch, device):
        self.axis, self.batch, self.device = axis, batch, device
        self.rank = axis.index
        self.stats, self.stats_back = ShardStats(), ShardStats()

    def layout(self, x: torch.Tensor) -> Tuple[List[int], List[int]]:
        """(first rows, heights) of every shard's part of the map."""
        return D._timed(self.stats, D.row_layout, self.axis, x.shape[-2], x.device)

    def window(self, x: torch.Tensor, k: int, s: int, p: int,
               fill: Optional[float]) -> torch.Tensor:
        """:meth:`Shard.window` between ranks (parallel/distributed.py:
        halo_window): only the rows the window reads move."""
        starts, heights = self.layout(x)
        r, height = self.rank, sum(heights)
        lo, hi = window_rows(starts[r], heights[r], height, r, k, s, p, fill)

        def overlap(a0, a1, j):
            a, b = max(a0, starts[j]), min(a1, starts[j] + heights[j])
            return (j, a, b) if a < b else None

        others = [j for j in range(len(heights)) if j != r]
        recv = tuple(o for o in (overlap(lo, hi, j) for j in others) if o)
        send = []
        for j in others:
            jlo, jhi = window_rows(starts[j], heights[j], height, j, k, s, p, fill)
            o = overlap(jlo, jhi, r)
            if o:
                send.append((j, o[1], o[2]))
        own = overlap(lo, hi, r) or (r, 0, 0)
        plan = D.HaloPlan(lo, hi, starts[r], own[1:], recv, tuple(send), height, fill)
        return D.halo_window(x, plan, self.axis, self.stats, self.stats_back)

    def gather(self, x: torch.Tensor, summed: bool = True) -> Tuple[torch.Tensor, slice]:
        """The whole map and this shard's rows of it (parallel/
        distributed.py:row_gather; ``summed``: the backward the caller
        needs)."""
        starts, heights = self.layout(x)
        whole = D.row_gather(x, self.axis, heights, summed, self.stats, self.stats_back)
        ia = starts[self.rank]
        return whole, slice(ia, ia + x.shape[-2])

    @contextlib.contextmanager
    def whole_map(self):
        """Layers inside run on a whole (gathered) map, replicated over the
        ``sp`` group: no rule applies, and BatchNorm sums over the batch
        axis."""
        _LOCAL.shard = None
        try:
            with D.global_batch(self.batch, self.batch):
                yield
        finally:
            _LOCAL.shard = self

    on_whole_map = Shard.on_whole_map

    def gather_outputs(self, maps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The head's maps whole, for a loss that every rank of the group
        computes from them: each rank's gradient flows back through its own
        rows alone."""
        return [self.gather(m, summed=False)[0] for m in maps]


@contextlib.contextmanager
def acting(shard):
    """This thread runs the forward (and backward) of ``shard`` (None: no
    ``sp`` split)."""
    before = current()
    _LOCAL.shard = shard
    try:
        yield
    finally:
        _LOCAL.shard = before


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: a layer recomputed in
    the backward (on the autograd engine's thread, on a card) runs under
    the shard that ran its forward."""
    return contextlib.nullcontext(), acting(current())


def _worker(shard: Shard, fn, arg, streams: dict, out: list, index: int) -> None:
    """One shard's task: ``out[index]`` becomes ("ok", result), ("failed",
    its exception, which run() re-raises naming the shard) or ("stopped",
    when another shard failed); a shard that did not finish breaks its
    group's barrier, so that the others stop at once."""
    _LOCAL.shard = shard
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            for s in streams.values():  # setting a stream may make its card current
                stack.enter_context(torch.cuda.stream(s))
            if shard.device.type == "cuda":  # the C launchers launch on the current card
                stack.enter_context(torch.cuda.device(shard.device))
            out[index] = ("ok", fn(arg))
    except ShardFailed as e:
        out[index] = ("stopped", e)
    except Exception as e:  # noqa: BLE001 (re-raised by run, naming the shard)
        out[index] = ("failed", e)
    finally:
        if out[index] is None or out[index][0] != "ok":
            shard.group.barrier.abort()
        _LOCAL.shard = None


class Workers:
    """Long-lived threads that run the shards of :func:`run`, thread k the
    k-th shard of every call. PyTorch keeps state per thread that a fresh
    thread rebuilds on its first convolutions (cuDNN's execution plans:
    a yolov8l forward in new threads took ~0.3 s on an H100 against ~0.02
    in the main thread), so a caller that runs sp groups again and again
    (``engine.Detector``) keeps one pool. One call runs at a time: two
    interleaved on the same threads would each wait at its barrier for a
    shard queued behind the other's. The threads end when the pool is
    closed or collected, and at the interpreter's exit (a thread still
    holding CUDA state when the interpreter tears down aborts it)."""

    def __init__(self):
        self._queues: List[queue.SimpleQueue] = []
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._finalizer = weakref.finalize(self, _stop, self._queues, self._threads)

    def run(self, tasks: Sequence[Callable[[], None]], timeout: float) -> List[threading.Event]:
        """Run ``tasks[k]`` on thread k; -> whether each has finished, after
        all did or ``timeout`` seconds passed (the pool then drops its
        threads: a stuck one is not handed more work)."""
        with self._lock:
            while len(self._queues) < len(tasks):
                q: queue.SimpleQueue = queue.SimpleQueue()
                t = threading.Thread(target=_serve, args=(q,), daemon=True,
                                     name=f"sp-worker-{len(self._queues)}")
                t.start()
                self._queues.append(q)
                self._threads.append(t)
            done = [threading.Event() for _ in tasks]
            for q, task, ev in zip(self._queues, tasks, done):
                q.put((task, ev))
            deadline = time.monotonic() + timeout
            for ev in done:
                ev.wait(max(0.0, deadline - time.monotonic()))
            if not all(ev.is_set() for ev in done):
                _stop(self._queues, [])
                self._queues.clear()
                self._threads.clear()
            return done

    def close(self) -> None:
        self._finalizer()


def _serve(q: "queue.SimpleQueue") -> None:
    while True:
        item = q.get()
        if item is None:
            return
        task, done = item
        try:
            task()
        finally:
            done.set()


def _stop(queues, threads, timeout: float = 10.0) -> None:
    """End the threads serving ``queues``, joining ``threads``."""
    for q in queues:
        q.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join(timeout)


def run(jobs: Sequence[Tuple[SpGroup, Callable, Sequence, Sequence[int]]],
        timeout: float = 600.0, workers: Optional[Workers] = None) -> List[list]:
    """Run every job at once, one thread a shard (``workers``' threads, or
    new ones): a job is (group, fn, one argument a shard, one overlap a
    shard), ``fn(arg)`` runs under its shard's context without autograd, on
    its device, on the caller's current stream of every device of the
    group. -> each job's results in shard order. A shard that raises stops
    its group; the call then raises :class:`ShardFailed` naming it, chained
    to its error. A shard still running after ``timeout`` seconds raises
    TimeoutError."""
    tasks, names, outs = [], [], []
    for g, fn, args, overlaps in jobs:
        if len(args) != g.size or len(overlaps) != g.size:
            raise ValueError(f"an sp group of {g.size} shards given {len(args)} inputs")
        streams = {d: torch.cuda.current_stream(d) for d in g.devices if d.type == "cuda"}
        out = [None] * g.size
        outs.append(out)
        for r in range(g.size):
            tasks.append(functools.partial(_worker, Shard(g, r, overlaps[r]), fn, args[r],
                                           streams, out, r))
            names.append((g, r))
    pool = workers or Workers()
    try:
        done = pool.run(tasks, timeout)
    finally:
        if workers is None:
            pool.close()
    hung = [names[k] for k, ev in enumerate(done) if not ev.is_set()]
    if hung:
        for g, _ in hung:
            g.barrier.abort()
        raise TimeoutError(f"sp shards {[r for _, r in hung]} still running after {timeout} s")
    for (g, _, _, _), out in zip(jobs, outs):
        for r, entry in enumerate(out):
            status, value = entry or ("failed", RuntimeError("ended without a result"))
            if status == "failed":
                raise ShardFailed(f"sp shard {r} of {g.size} on {g.devices[r]} failed: "
                                  f"{type(value).__name__}: {value}") from value
    return [[entry[1] for entry in out] for out in outs]
