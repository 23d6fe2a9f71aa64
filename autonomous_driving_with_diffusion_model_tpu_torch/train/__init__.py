"""Training (counterpart of the JAX package's ``train/``)."""

from .checkpoint import (
    export_torch_checkpoint,
    import_torch_checkpoint,
    load_checkpoint,
    load_eval_state_dict,
    resume,
    save_checkpoint,
)
from .ema import EmaConfig, EmaState, ema_decay_for_step, ema_init, ema_update
from .state import (
    StepDraws,
    TrainState,
    create_train_state,
    draw_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "StepDraws",
    "create_train_state",
    "draw_step",
    "make_train_step",
    "make_lr_schedule",
    "make_optimizer",
    "EmaConfig",
    "EmaState",
    "ema_init",
    "ema_update",
    "ema_decay_for_step",
    "export_torch_checkpoint",
    "import_torch_checkpoint",
    "save_checkpoint",
    "load_checkpoint",
    "load_eval_state_dict",
    "resume",
]
