"""PyTorch / CUDA port of ``ood_in_object_detection_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: module names mirror it
one to one, public functions keep its layouts (images and neck maps NHWC at
the boundary), and every Pallas kernel on the ported path has a hand-written
CUDA kernel here (``csrc/``, built by ``ops/kernels/_build.py``) with a plain
PyTorch version beside it. This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level API (no torch import at package import time)
    if name == "Detector":
        from .engine import Detector

        return Detector
    if name == "build_model":
        from .models import build_model

        return build_model
    if name == "build_ood_method":
        from .cli.factory import build_ood_method

        return build_ood_method
    raise AttributeError(name)
