"""Training of the port: the train step (`train`) and checkpoints
(`checkpoint`)."""

from occnet_tpu_torch.training.train import (  # noqa: F401
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
