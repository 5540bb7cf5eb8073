"""Train state: one object carrying everything a training step mutates
(port of declip_tpu/train/state.py).

The JAX package keeps params in an immutable pytree; here they are the fp32
parameters of the model, which the step updates in place, beside the
optimizer state, the EMA shadow, the EMA_logit_scale guard's buffers
(declip_solver.py:64-86), DeCLIP's NN text bank and MoCo's and CLSA's
key encoder and queue (``ssl``, models/ssl_builders.py). BatchNorm running
statistics (the JAX package's ``batch_stats``) are the model's buffers.
Under FSDP or expert parallelism the parameters, slots and EMA of
``shards`` are this rank's parts (parallel/fsdp.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from declip_tpu_torch.models.memory_bank import BankState
from declip_tpu_torch.models.ssl_builders import MoCoState
from declip_tpu_torch.optim import OptState


@dataclass
class TrainState:
    step: int  # number of completed steps
    model: nn.Module  # its parameters are the params, fp32
    opt_state: OptState
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    # EMA_logit_scale guard state (declip_solver.py:64-86)
    logit_ema_buffer: Optional[torch.Tensor] = None
    logit_clip_count: Optional[torch.Tensor] = None
    # DeCLIP's NN memory bank of text features (return_nn_bank)
    bank_text: Optional[BankState] = None
    # MoCo's and CLSA's momentum encoder and negatives queue
    ssl: Optional[MoCoState] = None
    # the parameters this rank holds a part of (FSDP, expert
    # parallelism): a parallel.fsdp.ShardPlan, set by shard_train_state
    shards: Optional[Any] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def new_train_state(*, model: nn.Module, opt_state: OptState,
                    ema_params: Optional[Dict[str, torch.Tensor]] = None,
                    step: int = 0, with_logit_guard: bool = False,
                    bank_text: Optional[BankState] = None,
                    ssl: Optional[MoCoState] = None) -> TrainState:
    device = next(model.parameters()).device
    return TrainState(
        step=step,
        model=model,
        opt_state=opt_state,
        ema_params=ema_params,
        logit_ema_buffer=(
            torch.tensor(3.125, dtype=torch.float32, device=device)
            if with_logit_guard else None),
        logit_clip_count=(
            torch.zeros((), dtype=torch.int32, device=device)
            if with_logit_guard else None),
        bank_text=bank_text,
        ssl=ssl,
    )
