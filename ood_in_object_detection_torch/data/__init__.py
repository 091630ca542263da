"""Datasets and batching, copied unchanged from ood_in_object_detection_tpu/data
(dataset.py, native.py, and the NumPy part of letterbox.py): NumPy, PIL and
PyYAML only."""

from .dataset import DetectionDataset, PaddedBatcher, Label  # noqa: F401
from .letterbox import letterbox_np, scale_boxes_back  # noqa: F401
