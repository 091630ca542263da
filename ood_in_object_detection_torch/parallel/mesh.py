"""Device meshes and batch sharding (port of
ood_in_object_detection_tpu/parallel/mesh.py).

A :class:`Mesh` is a ("dcn", "data", "sp", "model") grid of torch devices,
as the JAX package's is of JAX devices. The batch splits over ("dcn",
"data"): one host has one slice, so ``dcn`` folds into ``data`` and a batch
of B rows becomes ``dcn * data`` equal contiguous shards, in order, one per
mesh entry. Entries may repeat (the CPU, or one card named twice), so that
one card or the CPU can hold the data-parallel path.

- Inference is one process driving every entry
  (``engine.Detector.predict_sharded``): a replica of the model on each
  device, each shard through the unchanged predict step on its device, the
  outputs gathered onto the mesh's first device. An ``sp`` axis above 1
  splits each batch shard's image height over its ``sp`` entries
  (:attr:`Mesh.sp_groups`; ``parallel/spatial.py`` exchanges the halos).
  The ``model`` axis splits no work at inference, as in the JAX package's
  predict, whose weights are replicated over the whole mesh: each (batch
  shard, ``sp``) position runs on its ``model``-index-0 entry.
- Training is one process (rank) per entry under ``torch.distributed``
  (``parallel/distributed.py``, ``train/trainer.py:make_sharded_train_step``),
  rank r at the entry ``r`` of the mesh in row-major order. Each rank holds
  its batch shard's rows and, with ``sp`` above 1, its equal slab of their
  image height (:func:`device_put_batch`, :func:`prefetch_to_device`); with
  ``model`` above 1, its slice of the output channels of every conv that
  :func:`param_spec` splits (``shard_state``). BatchNorm's statistics, the
  loss normalizer and the gradient are those of the global batch, as in the
  JAX package's one logical computation: :func:`mesh_groups` builds the
  process groups that carry them.
"""

from __future__ import annotations

import collections
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("dcn", "data", "sp", "model")
BATCH_AXES = ("dcn", "data")


def as_device(entry) -> torch.device:
    """A mesh entry as a torch device: an int or a digit string is that
    CUDA card, 'cpu' the CPU, anything else ``torch.device(entry)``. A card
    that is not visible raises."""
    if isinstance(entry, int) or (isinstance(entry, str) and entry.strip().isdigit()):
        dev = torch.device("cuda", int(entry))
    else:
        dev = torch.device(entry.strip() if isinstance(entry, str) else entry)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh entry {entry!r}: CUDA is not available (name 'cpu' "
                               "entries to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh entry {entry!r}: card {dev.index} is missing "
                               f"({torch.cuda.device_count()} visible)")
    return dev


def parse_devices(spec: str) -> List[torch.device]:
    """A CLI's ``--device``: '0', 'cpu', or a comma list such as '0,1,2,3',
    '0,0' or 'cpu,cpu' (one entry per mesh position)."""
    return [as_device(s) for s in str(spec).split(",") if s.strip()]


class Mesh:
    """A ("dcn", "data", "sp", "model") grid of torch devices."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is {len(AXES)}-D, got {devices.shape}")
        self.devices = devices
        self._groups = None  # this rank's MeshGroups, built by mesh_groups

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(AXES, self.devices.shape))

    @property
    def sp_groups(self) -> List[List[torch.device]]:
        """Per batch shard, in batch order (the ("dcn", "data") entries,
        dcn-major), its ``sp`` entries in height order, at ``model`` index
        0."""
        d = self.devices[..., 0]
        return [list(g) for g in d.reshape(-1, d.shape[-1])]

    @property
    def batch_devices(self) -> List[torch.device]:
        """One device per batch shard, in batch order: its first ``sp``
        entry at ``model`` index 0, where its outputs land."""
        return [g[0] for g in self.sp_groups]

    @property
    def size(self) -> int:
        return self.devices.size

    def place(self, rank: int) -> "Place":
        """Where rank ``rank`` of a training run (one rank per entry, in
        row-major order) sits on the mesh."""
        dcn, data, sp, model = np.unravel_index(rank, self.devices.shape)
        return Place(rank, int(dcn * self.devices.shape[1] + data), int(sp), int(model),
                     self.devices.reshape(-1)[rank])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices.reshape(-1)]})"


class Place(NamedTuple):
    """A rank's place on a mesh: its batch shard (the ("dcn", "data")
    position, dcn-major), its ``sp`` and ``model`` indices, its device."""
    rank: int
    batch: int
    sp: int
    model: int
    device: torch.device


class Axis(NamedTuple):
    """Ranks of a training run that one collective spans: ``group`` (the
    default group when it spans every rank; None for a rank alone, where
    nothing is exchanged), the ranks in axis order and this rank's index
    among them."""
    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class MeshGroups(NamedTuple):
    """The process groups a training rank needs on its mesh
    (:func:`mesh_groups`):

    - ``sp``: the ranks of its batch shard at its ``model`` index, in
      height order (halos, row gathers);
    - ``model``: the ranks of its batch shard at its ``sp`` index
      (the tensor-parallel pair);
    - ``reduce``: every rank at its ``model`` index (BatchNorm's sums, the
      gradient);
    - ``batch``: one rank per batch shard, at its ``sp`` and ``model``
      indices (the loss normalizer and terms; BatchNorm on a gathered map).
    """
    place: Place
    sp: Axis
    model: Axis
    reduce: Axis
    batch: Axis


def visible_cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []


def make_mesh(data: Optional[int] = None, model: int = 1, sp: int = 1, dcn: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("dcn", "data", "sp", "model") mesh over ``devices`` (entries as
    :func:`as_device` takes them; the CPU or a card may repeat), by default
    every visible card. ``data`` defaults to what the other axes leave."""
    if devices is None:
        devices = visible_cards()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA card is visible; pass devices=['cpu', ...] "
                               "to build a mesh on the CPU")
    devs = [as_device(d) for d in devices]
    n = len(devs)
    if data is None:
        data = n // (dcn * model * sp)
    if dcn * data * sp * model != n or n == 0:
        raise ValueError(f"mesh {dcn}x{data}x{sp}x{model} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(dcn, data, sp, model))


def num_slices(devices=None) -> int:
    """Slices among the devices: 1, as one host has one."""
    return 1


def make_multislice_mesh(model: int = 1, sp: int = 1, devices=None) -> Mesh:
    """:func:`make_mesh` with ``dcn`` 1: on one host the batch axes are
    ``data`` alone."""
    return make_mesh(model=model, sp=sp, devices=devices)


def batch_spec() -> Tuple[str, ...]:
    """The axes the leading (batch) dimension splits over."""
    return BATCH_AXES


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: its leading dimension split over
    ``spec``'s axes (one contiguous shard per batch device), or, with an
    empty spec, a whole copy on every distinct device."""
    mesh: Mesh
    spec: Tuple[str, ...]

    @property
    def devices(self) -> List[torch.device]:
        if self.spec:
            return self.mesh.batch_devices
        return list(dict.fromkeys(self.mesh.devices.reshape(-1)))

    def slices(self, n: int) -> List[slice]:
        """The rows of each device's part of an n-row tensor; a batch that
        does not divide over the shards raises ValueError."""
        k = len(self.devices)
        if not self.spec:
            return [slice(0, n)] * k
        if n % k:
            raise ValueError(f"a batch of {n} does not divide over the mesh's {k} "
                             f"({'x'.join(self.spec)}) shards")
        s = n // k
        return [slice(i * s, (i + 1) * s) for i in range(k)]


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, batch_spec())


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def param_spec(path, leaf, model_axis_size: int) -> Tuple:
    """Tensor-parallel spec of a parameter: a conv weight, (cout, cin, kh,
    kw) in torch, splits cout over "model" when it divides and is at least
    64 wide; everything else is replicated (the JAX package's rule on its
    (kh, kw, cin, cout) kernels)."""
    if model_axis_size <= 1:
        return ()
    if leaf.ndim == 4 and leaf.shape[0] % model_axis_size == 0 and leaf.shape[0] >= 64:
        return ("model", None, None, None)
    return ()


def shard_params(params, mesh: Mesh) -> dict:
    """{name: :func:`param_spec`} for a module's parameters or a
    state_dict, under the mesh's ``model`` axis."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return {name: param_spec(name, t, mesh.shape["model"]) for name, t in items}


def mesh_groups(mesh: Mesh) -> MeshGroups:
    """This rank's :class:`MeshGroups` on ``mesh`` under a process group of
    one rank per entry. Every rank must call it at the same point: each
    group spanning more than one rank and fewer than all is created with
    ``dist.new_group`` in the same order on every rank (groups of one rank
    need none; one spanning all ranks is the default group). Built once a
    mesh object."""
    if mesh._groups is not None:
        return mesh._groups
    dist = torch.distributed
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != mesh.size:
        raise ValueError(f"a process group of {world} ranks on a mesh of {mesh.size} entries: "
                         "run one rank per mesh entry (parallel/distributed.py:spawn)")
    grid = np.arange(world).reshape(mesh.devices.shape)
    dcn, data, sp, model = grid.shape
    # every rank set of each kind, one row a set, in the same order on every rank
    kinds = {
        "sp": grid.transpose(0, 1, 3, 2).reshape(-1, sp),
        "model": grid.reshape(-1, model),
        "reduce": grid.transpose(3, 0, 1, 2).reshape(model, -1),
        "batch": grid.reshape(dcn * data, sp * model).T,
    }
    axes = {}
    for kind, sets in kinds.items():
        for ranks in sets:
            ranks = tuple(int(r) for r in ranks)
            if 1 < len(ranks) < world:
                group = dist.new_group(list(ranks))
            else:
                group = None if len(ranks) == 1 else dist.group.WORLD
            if rank in ranks:
                axes[kind] = Axis(group, ranks, ranks.index(rank))
    mesh._groups = MeshGroups(mesh.place(rank), **axes)
    return mesh._groups


def local_shards(mesh: Mesh) -> List[Place]:
    """The mesh places this process feeds: under a process group (one rank
    per mesh entry, parallel/distributed.py), the rank's own; in one
    process, every entry in rank order (on a mesh whose ``sp`` and
    ``model`` axes are 1: its batch shards)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
        if world != mesh.size:
            raise ValueError(f"a process group of {world} ranks on a mesh of {mesh.size} "
                             "entries: run one rank per mesh entry")
        return [mesh.place(rank)]
    return [mesh.place(r) for r in range(mesh.size)]


def sp_rows(height: int, mesh: Mesh) -> List[slice]:
    """Each ``sp`` index's slab of an image height: equal slabs of a whole
    number of rows at the models' largest stride
    (parallel/spatial.py:row_spans; ValueError otherwise)."""
    from ..models.head import STRIDES
    from .spatial import row_spans

    return [slice(lo, hi) for lo, hi in row_spans(height, mesh.shape["sp"], max(STRIDES))]


def _put(value, rows: slice, n: int, device, slab: Optional[slice]):
    """A place's part of one batch entry: its rows of an array or tensor
    with a leading batch dimension (and of a 4-D one, (B, H, W, C) as the
    JAX package's images, its ``slab`` of H), or of a list of length n;
    anything else as is."""
    if isinstance(value, (np.ndarray, torch.Tensor)):
        part = value[rows]
        if slab is not None and part.ndim == 4:
            part = part[:, slab]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(device)
    if isinstance(value, (list, tuple)) and len(value) == n:
        return value[rows]
    return value


def device_put_batch(batch, mesh: Mesh) -> list:
    """This process's parts of a host batch (a dict of arrays with a
    leading batch dimension, or one array): one entry per place of
    :func:`local_shards`, on its device: its batch shard's rows and, on an
    ``sp`` axis above 1, of 4-D arrays (images, (B, H, W, C)) its slab of
    the height (:func:`sp_rows`; the JAX package's ``P(BATCH_AXES, "sp",
    None, None)``); every other entry (labels, boxes in whole-image pixels,
    masks) split over the batch only. A batch that does not divide over the
    mesh, or a height that does not split, raises ValueError."""
    n = len(batch[next(iter(batch))]) if isinstance(batch, dict) else len(batch)
    rows = batch_sharding(mesh).slices(n)
    out = []
    for pl in local_shards(mesh):
        def put(v):
            slab = None
            if mesh.shape["sp"] > 1 and getattr(v, "ndim", 0) == 4:
                slab = sp_rows(v.shape[1], mesh)[pl.sp]
            return _put(v, rows[pl.batch], n, pl.device, slab)

        out.append({k: put(v) for k, v in batch.items()} if isinstance(batch, dict)
                   else put(batch))
    return out


TRAIN_KEYS = ("images", "gt_labels", "gt_bboxes", "gt_mask")


def prefetch_to_device(batches: Iterable[dict], mesh: Mesh, size: int = 2):
    """Training batches from a host iterator as tensors on this process's
    device, in the trainer's layout (train/trainer.py:batch_to: images
    (B, 3, H, W) f32): the process feeds one place of ``mesh`` (a one-entry
    mesh, or its rank's part of each global batch under a process group:
    its batch shard's rows and, on an ``sp`` axis, its slab of the images'
    height, as :func:`device_put_batch` places them). On a card, up to
    ``size`` batches ahead are copied from pinned memory on a side stream;
    each is handed over once its copy is done (the current stream waits on
    its event)."""
    from ..train.trainer import batch_to

    shards = local_shards(mesh)
    if len(shards) != 1:
        raise ValueError("prefetch_to_device feeds one device a process; a training mesh "
                         "runs one rank per entry (parallel/distributed.py:spawn)")
    (place,) = shards
    device = place.device
    sharding = batch_sharding(mesh)

    def rows(b):
        part = {k: b[k][sharding.slices(len(b[k]))[place.batch]] for k in TRAIN_KEYS}
        if mesh.shape["sp"] > 1:
            part["images"] = part["images"][:, sp_rows(part["images"].shape[1], mesh)[place.sp]]
        return part

    if device.type != "cuda" or size <= 0:
        for b in batches:
            yield batch_to(rows(b), device)
        return
    side = torch.cuda.Stream(device)
    pending = collections.deque()

    def ready(item):
        dev, done = item
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in dev.values():
            t.record_stream(cur)
        return dev

    for b in batches:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in rows(b).items()}
        with torch.cuda.stream(side):
            dev = batch_to(host, device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        pending.append((dev, done))
        if len(pending) > size:
            yield ready(pending.popleft())
    while pending:
        yield ready(pending.popleft())
