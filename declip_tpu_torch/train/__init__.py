from declip_tpu_torch.train.ema import EmaConfig, ema_step, init_ema  # noqa: F401
from declip_tpu_torch.train.state import TrainState, new_train_state  # noqa: F401
from declip_tpu_torch.train.train_step import (  # noqa: F401
    make_loss_fn,
    make_losses_from_out,
    make_train_step,
    method_of,
)
