"""Training runtime on one card: trainer, optimizers, checkpoints, metrics,
recipes.

Counterpart of ``audiogpt_tpu/train``, which replaces the reference's forked
pytorch-lightning stack (``NeuralSeq/utils/pl_utils.py``,
``tasks/base_task.py``).
"""

from audiogpt_tpu_torch.train.checkpoint import CheckpointStore
from audiogpt_tpu_torch.train.metrics import AvgMeter, MeterBank, MetricsLogger
from audiogpt_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            warmup_rsqrt_schedule)
from audiogpt_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["CheckpointStore", "AvgMeter", "MeterBank", "MetricsLogger",
           "OptimConfig", "make_optimizer", "warmup_rsqrt_schedule",
           "Trainer", "TrainerConfig"]
