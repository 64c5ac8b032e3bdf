"""Training: losses, schedule, optimizer and the train / eval steps."""

from tec_mollm_tpu_torch.training.loss import huber_loss, pinball_loss
from tec_mollm_tpu_torch.training.optimizer import is_trainable, trainable_mask
from tec_mollm_tpu_torch.training.pretrain import (
    PretrainState,
    create_pretrain_state,
    make_pretrain_step,
    val_loss,
)
from tec_mollm_tpu_torch.training.schedule import cosine_annealing_warm_restarts, warmup_cosine_decay
from tec_mollm_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_sum_loss_fn,
    make_train_step,
    point_forecast,
)

__all__ = [
    "PretrainState",
    "TrainState",
    "cosine_annealing_warm_restarts",
    "create_pretrain_state",
    "create_train_state",
    "huber_loss",
    "is_trainable",
    "make_eval_step",
    "make_pretrain_step",
    "make_sum_loss_fn",
    "make_train_step",
    "pinball_loss",
    "point_forecast",
    "trainable_mask",
    "val_loss",
    "warmup_cosine_decay",
]
