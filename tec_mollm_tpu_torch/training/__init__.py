"""Training: losses, schedule, optimizer and the train / eval steps."""

from tec_mollm_tpu_torch.training.loss import huber_loss, pinball_loss
from tec_mollm_tpu_torch.training.optimizer import is_trainable, trainable_mask
from tec_mollm_tpu_torch.training.schedule import cosine_annealing_warm_restarts
from tec_mollm_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_sum_loss_fn,
    make_train_step,
)

__all__ = [
    "TrainState",
    "cosine_annealing_warm_restarts",
    "create_train_state",
    "huber_loss",
    "is_trainable",
    "make_eval_step",
    "make_sum_loss_fn",
    "make_train_step",
    "pinball_loss",
    "trainable_mask",
]
