"""Training: the train step (loss, gradients, AdamW) and the trainer."""
from .step import (  # noqa: F401
    TrainConfig,
    TrainState,
    grads_and_metrics,
    init_state,
    local_batch,
    make_train_step,
    shard_state,
    state_block_specs,
    state_blocks,
    state_shapes,
    train_step,
)
from .trainer import StragglerMonitor, Trainer, TrainerConfig  # noqa: F401
