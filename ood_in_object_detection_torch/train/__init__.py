"""Training (port of ood_in_object_detection_tpu/train): the Task-Aligned
Assigner, the detection losses and the trainer, on one device or data
parallel over a mesh (``shard_state``, ``make_sharded_train_step``; one
rank per mesh entry, parallel/distributed.py)."""

from .loss import LossBreakdown, ciou, detection_loss, df_loss  # noqa: F401
from .tal import AssignResult, assign  # noqa: F401
from .trainer import (TrainConfig, TrainState, init_state, make_sharded_train_step,  # noqa: F401
                      shard_state, train_step)
