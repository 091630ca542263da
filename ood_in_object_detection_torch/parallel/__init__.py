"""Parallelism over several devices (port of
ood_in_object_detection_tpu/parallel): meshes, batch sharding and a
training rank's process groups (``mesh.py``), the ``sp`` shards that split
an image's height, threads at inference and ranks in training
(``spatial.py``), and the process group of a training run with its
collectives (``distributed.py``)."""

from .mesh import (  # noqa: F401
    BATCH_AXES, Mesh, Sharding, batch_sharding, batch_spec, device_put_batch, make_mesh,
    make_multislice_mesh, mesh_groups, num_slices, param_spec, parse_devices,
    prefetch_to_device, replicated, shard_params,
)
