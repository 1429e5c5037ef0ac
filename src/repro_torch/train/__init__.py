"""Training: the train step (loss, gradients, AdamW) and the trainer."""
from .step import (  # noqa: F401
    TrainConfig,
    TrainState,
    grads_and_metrics,
    init_state,
    make_train_step,
    train_step,
)
from .trainer import StragglerMonitor, Trainer, TrainerConfig  # noqa: F401
