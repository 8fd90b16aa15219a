"""Training layer of the port: schedule, optimizers, train / eval steps,
metrics, checkpoints and the driver (``train.driver.train``)."""

from research_image_retrieval_tpu_torch.train.checkpoint import (
    CheckpointManager,
    partial_load,
)
from research_image_retrieval_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    shard_train_state,
)
from research_image_retrieval_tpu_torch.train.metrics import (
    AverageMeter,
    DeferredUpdate,
    JsonlWriter,
    MetricLogger,
    TensorBoardWriter,
)
from research_image_retrieval_tpu_torch.train.optimizer import (
    make_adamw_optimizer,
    make_sgd_optimizer,
    weight_decay_mask,
)
from research_image_retrieval_tpu_torch.train.preemption import (
    PreemptionGuard,
)
from research_image_retrieval_tpu_torch.train.schedule import (
    warmup_cosine_schedule,
)

__all__ = [
    "AverageMeter",
    "CheckpointManager",
    "DeferredUpdate",
    "JsonlWriter",
    "MetricLogger",
    "PreemptionGuard",
    "TensorBoardWriter",
    "TrainState",
    "create_train_state",
    "make_adamw_optimizer",
    "make_eval_step",
    "make_sgd_optimizer",
    "make_train_step",
    "partial_load",
    "shard_train_state",
    "warmup_cosine_schedule",
    "weight_decay_mask",
]
