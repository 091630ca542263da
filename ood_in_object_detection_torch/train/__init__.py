"""Training (port of ood_in_object_detection_tpu/train): the Task-Aligned
Assigner, the detection losses and the trainer. The mesh-sharded step of
the JAX package is ROADMAP.md A12 (multi-GPU)."""

from .loss import LossBreakdown, ciou, detection_loss, df_loss  # noqa: F401
from .tal import AssignResult, assign  # noqa: F401
from .trainer import TrainConfig, TrainState, init_state, train_step  # noqa: F401
