from .state import (Optimizer, TrainState, broadcast_state_, create_train_state,
                    make_optimizer)
from .step import loss_for_batch, make_eval_loss_step, make_train_step

__all__ = ["Optimizer", "TrainState", "broadcast_state_", "create_train_state", "loss_for_batch",
           "make_eval_loss_step", "make_optimizer", "make_train_step"]
