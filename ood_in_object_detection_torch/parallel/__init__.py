"""Parallelism over several devices (port of
ood_in_object_detection_tpu/parallel): meshes and batch sharding
(``mesh.py``), the ``sp`` group that splits an image's height at inference
(``spatial.py``) and the process group of a data-parallel training run
(``distributed.py``)."""

from .mesh import (  # noqa: F401
    BATCH_AXES, Mesh, Sharding, batch_sharding, batch_spec, device_put_batch, make_mesh,
    make_multislice_mesh, num_slices, param_spec, parse_devices, prefetch_to_device,
    replicated, shard_params,
)
