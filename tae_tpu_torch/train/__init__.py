"""Training of the port (counterpart of ``tae_tpu/train``): AdamW and the
learning-rate schedules, the train and eval step factories."""

from tae_tpu_torch.train.optim import (adamw, epoch_step_lr,  # noqa: F401
                                       no_decay_mask, step_lr)
from tae_tpu_torch.train.step import (TrainState, global_norm,  # noqa: F401
                                      make_eval_step, make_train_step)
