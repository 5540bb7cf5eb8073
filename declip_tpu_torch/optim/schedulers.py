"""Iteration-domain, warmup-aware LR schedules (port of
declip_tpu/optim/schedulers.py).

Pure ``step -> lr`` callables with the JAX package's indexing, which is the
reference's (prototype/lr_scheduler/scheduler.py): ``schedule(s)`` is the lr
the reference scheduler hands the s-th optimizer step of a fresh run, i.e.
``scheduler.step(curr_step=s+1)`` then ``get_lr()[0]``. Law by law:

- warmup (scheduler.py:78-84, requires warmup_steps >= 2): lr at curr < ws
  is ``base_lr + (warmup_lr - base_lr) * (curr-1)/(ws-1)``;
- ``Step`` (scheduler.py:134-142): multiplier prefix-product selected by
  ``bisect_right(lr_steps, curr)``;
- ``StepDecay`` (scheduler.py:188-197):
  ``warmup_lr * decay**((curr-ws)//step_size)``;
- ``Cosine`` (scheduler.py:235-246): cosine from warmup_lr to min_lr over
  ``(curr-ws)/(max_iter-ws)``;
- ``Poly`` (scheduler.py:289-298):
  ``warmup_lr * (1-(curr-ws)/max_iter)**power``.

The arithmetic is fp32, in the JAX package's order of operations, so both
packages hand the optimizer the same fp32 lr. Epoch variants
(StepEpoch/CosineEpoch) are converted to iterations by ``scheduler_entry``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from declip_tpu_torch.utils.registry import SCHEDULERS

Schedule = Callable[[int], float]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _with_warmup(decay_fn: Callable, base_lr, warmup_lr,
                 warmup_steps) -> Schedule:
    """decay_fn receives ``t = curr - warmup_steps`` (fp32, t >= 0 once the
    decay phase is live)."""

    def schedule(step) -> float:
        curr = _f32(step) + 1.0
        after = decay_fn(torch.clamp(curr - warmup_steps, min=0.0))
        if warmup_steps < 2:  # reference asserts ws >= 2 or ws == 0
            return float(after)
        if curr < warmup_steps:
            return float(base_lr + (warmup_lr - base_lr) * (curr - 1.0)
                         / (warmup_steps - 1))
        return float(after)

    return schedule


@SCHEDULERS.register(name="Step")
def step_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                  lr_mults: Sequence[float], lr_steps: Sequence[int],
                  max_iter: int = 0, **_) -> Schedule:
    def decay(t):
        curr = t + warmup_steps
        mult = _f32(1.0)
        acc = 1.0
        for milestone, m in zip(lr_steps, lr_mults):
            acc *= m
            # bisect_right(lr_steps, curr): milestone applies once curr >= it
            if curr >= milestone:
                mult = _f32(acc)
        return warmup_lr * mult

    return _with_warmup(decay, base_lr, warmup_lr, warmup_steps)


@SCHEDULERS.register(name="StepDecay")
def step_decay_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                        step_size: int, rate: Optional[float] = None,
                        decay: Optional[float] = None, max_iter: int = 0, **_
                        ) -> Schedule:
    rate = rate if rate is not None else decay  # reference kwarg is `decay`

    def _decay(t):
        n = torch.floor(t / step_size)
        return warmup_lr * torch.pow(_f32(rate), n)

    return _with_warmup(_decay, base_lr, warmup_lr, warmup_steps)


@SCHEDULERS.register(name="Cosine")
def cosine_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                    max_iter: int, min_lr: float = 0.0, **_) -> Schedule:
    total = max(max_iter - warmup_steps, 1)

    def decay(t):
        frac = torch.clamp(t / total, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return min_lr + (warmup_lr - min_lr) * cos

    return _with_warmup(decay, base_lr, warmup_lr, warmup_steps)


@SCHEDULERS.register(name="Poly")
def poly_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                  max_iter: int, power: float = 1.0, **_) -> Schedule:
    def decay(t):
        frac = torch.clamp(t / max_iter, 0.0, 1.0)
        return warmup_lr * torch.pow(1.0 - frac, power)

    return _with_warmup(decay, base_lr, warmup_lr, warmup_steps)


def scheduler_entry(cfg, *, max_iter: int, iters_per_epoch: int = 1
                    ) -> Schedule:
    """Build a schedule from a `{type, kwargs}` node.

    Epoch-domain types (StepEpoch/CosineEpoch) convert ``lr_epochs`` /
    ``max_epoch`` to iterations like lr_scheduler/__init__.py:4-17."""
    kind = cfg["type"]
    kwargs = dict(cfg.get("kwargs") or {})
    kwargs.setdefault("max_iter", max_iter)
    if "warmup_epoch" in kwargs:
        kwargs["warmup_steps"] = int(
            kwargs.pop("warmup_epoch") * iters_per_epoch)
    kwargs.setdefault("warmup_steps", 0)
    if kind == "StepEpoch":
        kind = "Step"
        kwargs["lr_steps"] = [
            int(e * iters_per_epoch) for e in kwargs.pop("lr_epochs")
        ]
    elif kind == "CosineEpoch":
        kind = "Cosine"
    return SCHEDULERS.get(kind)(**kwargs)
