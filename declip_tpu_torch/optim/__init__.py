"""Optimizer construction — the port of declip_tpu/optim/__init__.py's
``optim_entry``, for AdamW and Adam.

The JAX package chains optax stages; the port applies the same stages in the
same order to fp32 parameters, in place, with PyTorch's multi-tensor
(``torch._foreach_*``) ops:

1. the ``grad_clip`` stage (clip_solver.py:524-535): ``norm`` (optax's
   ``clip_by_global_norm``: kept when the norm is below the limit, else
   ``g / norm * limit``, no epsilon), ``value`` (elementwise clip),
   ``logit_scale_grad`` (elementwise clip of the logit_scale group) or
   ``constant`` (the logit_scale group's gradient zeroed);
2. Adam's moments and bias correction (optax ``scale_by_adam``), with the
   weight decay of each pconfig group added before them for Adam (coupled)
   or to the update after them for AdamW (decoupled);
3. the update times ``-lr``, lr = ``schedule(count)`` at the optimizer
   state's step count;
4. the frozen mask last (``frozen_param_paths``, e.g. ViT's conv1): frozen
   parameters get no update and no decay, though their moments advance as
   optax's do.

Parameters and optimizer state stay fp32 whatever the model's compute
dtype. The other optimizers of the JAX package (SGD, LARS, AdamW_SGD,
Adafactor, RMSprop, ...) are not ported yet (ROADMAP.md item 1.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from declip_tpu_torch.optim.param_groups import (  # noqa: F401
    group_labels,
    path_prefix_mask,
    weight_decay_masks,
)
from declip_tpu_torch.optim.schedulers import scheduler_entry  # noqa: F401

Schedule = Callable[[int], float]

_DECOUPLED = ("AdamW", "FP16AdamW", "FusedFP16AdamW")
_COUPLED = ("Adam",)
_CLIP_TYPES = ("norm", "value", "logit_scale_grad", "constant")


@dataclass
class OptState:
    """Adam's state: the step count (bias correction), fp32 moments by
    parameter name, and the schedule's own count, which optax keeps apart
    in ``ScaleByScheduleState`` (the two advance together unless
    :func:`fast_forward_schedule` moves the schedule's)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    sched_count: int = 0


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all elements (optax.global_norm),
    an fp32 0-dim tensor. On the CPU each tensor's squares go through
    ``torch.sum``, whose blocked summation keeps fp32 accurate: the CPU's
    norm kernels (``_foreach_norm``, ``vector_norm``) read 7e-4 low over a
    4096 x 4096 gradient (SLIP's ``predictor_sim``), which moved the
    reported norm 3e-4 off JAX's."""
    if tensors and tensors[0].device.type == "cpu":
        return torch.stack([torch.sum(torch.square(t.float()))
                            for t in tensors]).sum().sqrt()
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamRule:
    """Adam/AdamW with pconfig weight decay, a grad-clip stage and a frozen
    mask (see the module docstring). ``init`` makes the state, ``update_``
    advances it and the parameters in place."""

    def __init__(self, names: List[str], *, b1: float, b2: float,
                 eps: float, coupled: bool,
                 decays: Dict[float, List[str]], grad_clip: Optional[Dict],
                 logit_names: List[str], frozen: List[str],
                 schedule: Schedule):
        self.names = list(names)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.coupled = coupled
        index = {n: i for i, n in enumerate(self.names)}
        self.decays = {wd: [index[n] for n in ns] for wd, ns in decays.items()}
        self.clip = dict(grad_clip or {})
        self.logit_idx = [index[n] for n in logit_names]
        frozen_idx = {index[n] for n in frozen}
        self.live_idx = [i for i in range(len(self.names))
                         if i not in frozen_idx]
        self.schedule = schedule

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return OptState(
            count=0,
            mu={n: torch.zeros_like(params[n], dtype=torch.float32)
                for n in self.names},
            nu={n: torch.zeros_like(params[n], dtype=torch.float32)
                for n in self.names})

    def _clipped(self, g: List[torch.Tensor],
                 grad_norm: Optional[float]) -> List[torch.Tensor]:
        kind, limit = self.clip.get("type"), self.clip.get("value")
        if kind == "norm":
            if grad_norm is None:
                grad_norm = float(global_norm(g))
            if not grad_norm < float(limit):
                g = torch._foreach_div(g, grad_norm)
                torch._foreach_mul_(g, float(limit))
        elif kind == "value":
            g = [t.clamp(-float(limit), float(limit)) for t in g]
        elif kind == "logit_scale_grad":
            g = list(g)
            for i in self.logit_idx:
                g[i] = g[i].clamp(-float(limit), float(limit))
        elif kind == "constant":  # logit_scale frozen (clip_solver.py:501-503)
            g = list(g)
            for i in self.logit_idx:
                g[i] = torch.zeros_like(g[i])
        return g

    def _add_decay(self, u: List[torch.Tensor],
                   p: List[torch.Tensor]) -> List[torch.Tensor]:
        """u + wd * p on each decayed group (optax add_decayed_weights)."""
        u = list(u)
        for wd, idx in self.decays.items():
            summed = torch._foreach_add([u[i] for i in idx],
                                        [p[i] for i in idx], alpha=wd)
            for i, t in zip(idx, summed):
                u[i] = t
        return u

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: OptState,
                params: Mapping[str, torch.Tensor],
                grad_norm: Optional[float] = None) -> None:
        """One optimizer step, in place on ``params`` and ``state``.
        ``grad_norm``: the gradients' global norm where the caller has it
        already (the norm clip needs it)."""
        p = [params[n] for n in self.names]
        g = self._clipped([grads[n].float() for n in self.names], grad_norm)
        if self.coupled:
            g = self._add_decay(g, p)
        mu = [state.mu[n] for n in self.names]
        nu = [state.nu[n] for n in self.names]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        lr = self.schedule(state.sched_count)
        state.sched_count += 1
        state.count += 1
        # bias corrections in fp32, as optax computes them
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32)
                    ** state.count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32)
                    ** state.count)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        if not self.coupled:
            u = self._add_decay(u, p)
        live = self.live_idx
        u = [u[i] for i in live]
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_([p[i] for i in live], u)


def optim_entry(cfg: Mapping, model: nn.Module, schedule: Schedule, *,
                pconfig: Optional[Dict] = None,
                grad_clip: Optional[Dict] = None,
                frozen_mask: Optional[Mapping[str, bool]] = None) -> AdamRule:
    """Build the update rule from an optimizer ``{type, kwargs}`` node for
    ``model``'s parameters.

    frozen_mask: ``{parameter name: bool}``; True params get zero updates
    (the JAX analogue of ``requires_grad=False``, e.g. ViT's frozen conv1)."""
    kind = cfg["type"]
    kwargs = dict(cfg.get("kwargs") or {})
    pconfig = pconfig if pconfig is not None else cfg.get("pconfig") or {}
    if kind not in _DECOUPLED + _COUPLED:
        raise NotImplementedError(
            f"optimizer type {kind!r}: only AdamW and Adam are ported "
            f"(ROADMAP.md item 1.4)")
    kind_clip = (grad_clip or {}).get("type")
    if kind_clip in _CLIP_TYPES and "value" not in grad_clip:
        raise ValueError(f"grad_clip type {kind_clip!r} needs a value")
    labels = group_labels(model)
    wd = float(kwargs.get("weight_decay", 0.0))
    decays: Dict[float, List[str]] = {}
    for value, names in weight_decay_masks(labels, pconfig).items():
        rate = wd if value is None else value
        if rate and names:
            decays.setdefault(rate, []).extend(
                n for n in labels if n in names)
    b1, b2 = kwargs.get("betas", (0.9, 0.999))
    return AdamRule(
        list(labels), b1=float(b1), b2=float(b2),
        eps=float(kwargs.get("eps", 1e-8)), coupled=kind in _COUPLED,
        decays=decays, grad_clip=grad_clip,
        logit_names=[n for n, g in labels.items() if g == "logit_scale"],
        frozen=[n for n, f in (frozen_mask or {}).items() if f],
        schedule=schedule)


def fast_forward_schedule(opt_state: OptState, step: int) -> OptState:
    """Set ``opt_state``'s schedule count to ``step`` (port of
    declip_tpu/optim/__init__.py:225).

    Used by the reference-exact rollback mode (declip_solver.py:600-607):
    the reference rebuilds a FRESH optimizer after a crash (Adam moments
    zeroed, bias correction restarted) but keeps evaluating its rebuilt
    scheduler at the current step. Adam's own ``count`` (bias correction)
    is deliberately NOT touched: the reference restarts it."""
    opt_state.sched_count = int(step)
    return opt_state
