from .head import REG_MAX, STRIDES, decode_detections  # noqa: F401
from .yolo import SCALES, SPEC_V8, YOLODetector, build_model, init_weights  # noqa: F401
