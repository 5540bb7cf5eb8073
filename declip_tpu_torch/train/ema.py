"""EMA of the parameters (port of declip_tpu/train/ema.py).

Rebuilds prototype/utils/ema.py as the JAX package does:
- warmup-ramped decay ``min(decay, (1+t)/(warmup+t))`` (ema.py:36-40),
- ``inner_T`` stride (update only when ``step % inner_T == 0``; effective
  decay ``decay**inner_T``, ema.py:16-18,41-42),
- an fp32 shadow, zero-initialised unless ``copy_init``.

The shadow is a ``{parameter name: fp32 tensor}`` dict, updated in place.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch


class EmaConfig(NamedTuple):
    decay: float
    warmup: int = 1
    inner_T: int = 1
    copy_init: bool = False

    @property
    def effective_decay(self) -> float:
        return self.decay ** self.inner_T if self.inner_T > 1 else self.decay


def init_ema(params: Mapping[str, torch.Tensor],
             cfg: EmaConfig) -> Dict[str, torch.Tensor]:
    if cfg.copy_init:
        return {n: p.detach().float().clone() for n, p in params.items()}
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


@torch.no_grad()
def ema_step(ema_params: Dict[str, torch.Tensor],
             params: Mapping[str, torch.Tensor], step: int,
             cfg: EmaConfig) -> Dict[str, torch.Tensor]:
    """One EMA update in place (``e * decay + (1 - decay) * p``); a no-op on
    steps not divisible by inner_T. The decay is fp32, as in JAX."""
    if step % cfg.inner_T:
        return ema_params
    t = torch.tensor(float(step), dtype=torch.float32)
    decay = torch.minimum(torch.tensor(cfg.effective_decay,
                                       dtype=torch.float32),
                          (1.0 + t) / (cfg.warmup + t))
    names = list(ema_params)
    shadow = [ema_params[n] for n in names]
    torch._foreach_mul_(shadow, float(decay))
    torch._foreach_add_(shadow, [params[n].float() for n in names],
                        alpha=float(1.0 - decay))
    return ema_params
