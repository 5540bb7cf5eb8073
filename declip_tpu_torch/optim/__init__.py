"""Optimizer construction — the port of declip_tpu/optim/__init__.py's
``optim_entry``, for every optimizer type it accepts.

The JAX package chains optax stages; the port applies the same stages in the
same order to fp32 parameters, in place, with PyTorch's multi-tensor
(``torch._foreach_*``) ops:

1. the ``grad_clip`` stage (clip_solver.py:524-535): ``norm`` (optax's
   ``clip_by_global_norm``: kept when the norm is below the limit, else
   ``g / norm * limit``, no epsilon), ``value`` (elementwise clip),
   ``logit_scale_grad`` (elementwise clip of the logit_scale group) or
   ``constant`` (the logit_scale group's gradient zeroed); then, for
   ``AdamWithClip``/``AdamWWithClip`` with ``max_norm``, a second global
   norm clip (adam_clip.py);
2. the rule (below), with the weight decay of each pconfig group added to
   the gradient before it (coupled: SGD, Adam, RMSprop, Adadelta,
   Adagrad, LARS) or to the update after it (decoupled: AdamW,
   Adafactor);
3. the update times ``-lr``, lr = ``schedule(sched_count)``, the schedule's
   own count, which optax keeps apart in ``ScaleByScheduleState``;
4. the frozen mask last (``frozen_param_paths``, e.g. ViT's conv1): frozen
   parameters get no update and no decay, though their statistics advance
   as optax's do.

The rules (``optax`` names): ``SGD``/``FusedFP16SGD``/``FP16SGD``
(``trace``: momentum, nesterov); ``Adam``/``AdamW`` and their FP16/Fused
names and ``AdamWithClip``/``AdamWWithClip`` (``scale_by_adam``);
``RMSprop``/``FP16RMSprop`` (``scale_by_rms``, eps inside the square
root); ``Adadelta``; ``Adagrad`` (``scale_by_rss``); ``LARS``
(``optax.lars``: decay on every parameter whatever the pconfig, the trust
ratio, the lr, then the momentum trace); ``Adafactor``
(``scale_by_factored_rms``, ``clip_by_block_rms``,
``scale_by_param_block_rms``, an optional momentum EMA in
``dtype_momentum``, decoupled decay); ``AdamW_SGD``/``FP16AdamW_SGD``
(AdamW on the text side, SGD on the visual side, each at its own lr, the
whole-model clip once before the split). Unknown types raise ``KeyError``,
as in JAX.

Adafactor's and LARS's statistics are per leaf of the JAX package's
parameter tree, where ``nn.scan`` stacks a transformer's L layers of one
kind into one leaf and the patch embedding is a Dense [p*p*3, W]: the
rules take them over each leaf's view of the port's tensors
(``convert.jax_leaves``), and the factored second moment over the two
largest axes of the leaf's JAX shape.

Under FSDP or expert parallelism (``parallel/fsdp.py``) a rule updates
this rank's parts of the sharded parameters: the elementwise rules as
they are, the global norms over the shards (``Rule.plan``), LARS's trust
ratio from each leaf's squares summed over the shards, and Adafactor's
statistics on each leaf gathered whole (its factored moments stay
replicated: they are a leaf's rows and columns).

Each rule keeps its state in named slots of fp32 tensors (``OptState``:
Adam's ``mu``/``nu``, SGD's and LARS's ``trace``, Adafactor's ``v_row``/
``v_col``/``v`` by leaf and ``momentum``), which checkpoints save and
restore by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from declip_tpu_torch.optim.param_groups import (  # noqa: F401
    group_labels,
    path_prefix_mask,
    weight_decay_masks,
)
from declip_tpu_torch.optim.schedulers import scheduler_entry  # noqa: F401

Schedule = Callable[[int], float]

_CLIP_TYPES = ("norm", "value", "logit_scale_grad", "constant")
_ALIASES = {"FusedFP16SGD": "SGD", "FP16SGD": "SGD",
            "FP16AdamW": "AdamW", "FusedFP16AdamW": "AdamW",
            "FP16RMSprop": "RMSprop", "FP16AdamW_SGD": "AdamW_SGD"}
# the JAX package's text side of AdamW_SGD (path_prefix_mask there)
_TEXT_PREFIXES = ("text", "text_label_predictor", "text_mapping")


@dataclass
class OptState:
    """A rule's state: the step count, its slots ``{slot: {key:
    tensor}}`` (keys: parameter names, or JAX leaf keys for Adafactor's
    second moments), and the schedule's own count, which advances with
    ``count`` unless :func:`fast_forward_schedule` moves it."""

    count: int
    slots: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict)
    sched_count: int = 0

    @property
    def mu(self) -> Dict[str, torch.Tensor]:
        return self.slots["mu"]

    @property
    def nu(self) -> Dict[str, torch.Tensor]:
        return self.slots["nu"]


def state_bytes(state: OptState) -> int:
    """The bytes that ``state``'s slots hold."""
    return sum(t.numel() * t.element_size()
               for slot in state.slots.values() for t in slot.values())


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


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _zeros(params, names, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(params[n], dtype=dtype) for n in names}


class Rule:
    """The stages every rule shares (the module docstring's 1, 3, 4 and
    the pconfig decay of 2). A rule fills in ``_slots`` (its state) and
    ``_direction`` (its update before the lr); ``init`` makes the state and
    ``update_`` advances it and the parameters in place. ``plan``: the
    shards of a run under FSDP or expert parallelism
    (``parallel.fsdp.set_plan``), whose global norms count each shard
    once and whose per-leaf statistics take the whole leaf."""

    coupled = True
    plan = None

    def __init__(self, names: List[str], *, decays: Dict[float, List[str]],
                 grad_clip: Optional[Dict], logit_names: List[str],
                 frozen: List[str], schedule: Schedule,
                 max_norm: Optional[float] = None):
        self.names = list(names)
        index = {n: i for i, n in enumerate(self.names)}
        self.index = index
        self.decays = {wd: [index[n] for n in ns if n in index]
                       for wd, ns in decays.items()}
        self.clip = dict(grad_clip or {})
        self.logit_idx = [index[n] for n in logit_names if n in index]
        frozen_idx = {index[n] for n in frozen if n in index}
        self.live_idx = [i for i in range(len(self.names))
                         if i not in frozen_idx]
        self.schedule = schedule
        self.max_norm = max_norm

    # -------------------------------------------------------------- state
    def _slots(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        return {}

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return OptState(count=0, slots=self._slots(params))

    # ------------------------------------------------------------- stages
    def _norm(self, g: List[torch.Tensor]) -> Optional[float]:
        """The global norm of ``g`` over the shards (None with no plan:
        the clip computes it)."""
        if not self.plan:
            return None
        return float(self.plan.global_norm(dict(zip(self.names, g))))

    def _clipped(self, g: List[torch.Tensor],
                 grad_norm: Optional[float]) -> List[torch.Tensor]:
        kind, limit = self.clip.get("type"), self.clip.get("value")
        if kind in ("norm", "value"):
            if grad_norm is None and kind == "norm":
                grad_norm = self._norm(g)
            g = _whole_model_clip(self.clip, g, grad_norm)
        elif kind == "logit_scale_grad":
            g = list(g)
            for i in self.logit_idx:
                g[i] = g[i].clamp(-float(limit), float(limit))
        elif kind == "constant":  # logit_scale frozen (clip_solver.py:501-503)
            g = list(g)
            for i in self.logit_idx:
                g[i] = torch.zeros_like(g[i])
        if self.max_norm is not None:
            g = _clip_by_global_norm(g, self.max_norm, self._norm(g))
        return g

    def _add_decay(self, u: List[torch.Tensor],
                   p: List[torch.Tensor]) -> List[torch.Tensor]:
        """u + wd * p on each decayed group (optax add_decayed_weights)."""
        u = list(u)
        for wd, idx in self.decays.items():
            if not idx:
                continue
            summed = torch._foreach_add([u[i] for i in idx],
                                        [p[i] for i in idx], alpha=wd)
            for i, t in zip(idx, summed):
                u[i] = t
        return u

    def _direction(self, g: List[torch.Tensor], p: List[torch.Tensor],
                   state: OptState, step: int) -> List[torch.Tensor]:
        raise NotImplementedError

    def _apply(self, p: List[torch.Tensor], u: List[torch.Tensor],
               lr: float, state: OptState) -> None:
        """p += -lr * u on the live parameters."""
        live = self.live_idx
        u = torch._foreach_mul([u[i] for i in live], -lr)
        torch._foreach_add_([p[i] for i in live], u)

    def _step(self, grads: Mapping[str, torch.Tensor], state: OptState,
              params: Mapping[str, torch.Tensor], grad_norm: Optional[float],
              step: int, lr: float) -> None:
        """The update of step ``step`` (0-based) at ``lr``, counts left
        alone."""
        p = [params[n] for n in self.names]
        g = self._clipped([grads[n].float() for n in self.names], grad_norm)
        if self.coupled:
            g = self._add_decay(g, p)
        u = self._direction(g, p, state, step)
        if not self.coupled:
            u = self._add_decay(u, p)
        self._apply(p, u, lr, state)

    @torch.no_grad()
    def update_(self, grads: Mapping[str, torch.Tensor], state: OptState,
                params: Mapping[str, torch.Tensor],
                grad_norm: Optional[float] = None) -> None:
        """One optimizer step, in place on ``params`` and ``state``.
        ``grad_norm``: the gradients' global norm where the caller has it
        already (the norm clip needs it)."""
        lr = self.schedule(state.sched_count)
        self._step(grads, state, params, grad_norm, state.count, lr)
        state.sched_count += 1
        state.count += 1


def _whole_model_clip(clip: Dict, g: List[torch.Tensor],
                      grad_norm: Optional[float]) -> List[torch.Tensor]:
    """The ``norm`` or ``value`` grad-clip stage over every gradient."""
    limit = float(clip["value"])
    if clip["type"] == "norm":
        return _clip_by_global_norm(g, limit, grad_norm)
    return [t.clamp(-limit, limit) for t in g]


def _clip_by_global_norm(g: List[torch.Tensor], limit: float,
                         norm: Optional[float]) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: ``g`` below the limit, else
    ``g / norm * limit``."""
    if norm is None:
        norm = float(global_norm(g))
    if norm < limit:
        return g
    g = torch._foreach_div(g, norm)
    torch._foreach_mul_(g, limit)
    return g


class AdamRule(Rule):
    """Adam's moments and bias correction (optax ``scale_by_adam``);
    ``coupled``: Adam's decay before the moments, else AdamW's after."""

    def __init__(self, names, *, b1: float, b2: float, eps: float,
                 coupled: bool, **common):
        super().__init__(names, **common)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.coupled = coupled

    def _slots(self, params):
        return {"mu": _zeros(params, self.names),
                "nu": _zeros(params, self.names)}

    def _direction(self, g, p, state, step):
        mu = [state.slots["mu"][n] for n in self.names]
        nu = [state.slots["nu"][n] for n in self.names]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        # bias corrections in fp32, as optax computes them
        bc1 = float(1 - _f32(self.b1) ** (step + 1))
        bc2 = float(1 - _f32(self.b2) ** (step + 1))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        return u


def _trace(g: List[torch.Tensor], t: List[torch.Tensor], momentum: float,
           nesterov: bool) -> List[torch.Tensor]:
    """optax ``trace``: t = g + momentum * t in place; -> t, or with
    nesterov g + momentum * t."""
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, g)
    if not nesterov:
        return t
    u = torch._foreach_mul(t, momentum)
    torch._foreach_add_(u, g)
    return u


class SGDRule(Rule):
    """SGD with momentum and nesterov (optax ``trace``), coupled decay."""

    def __init__(self, names, *, momentum: float, nesterov: bool, **common):
        super().__init__(names, **common)
        self.momentum, self.nesterov = momentum, nesterov

    def _slots(self, params):
        return {"trace": _zeros(params, self.names)}

    def _direction(self, g, p, state, step):
        t = [state.slots["trace"][n] for n in self.names]
        return _trace(g, t, self.momentum, self.nesterov)


class RMSpropRule(Rule):
    """optax ``scale_by_rms``: nu = (1 - decay) g^2 + decay nu,
    u = g / sqrt(nu + eps)."""

    def __init__(self, names, *, decay: float, eps: float, **common):
        super().__init__(names, **common)
        self.decay, self.eps = decay, eps

    def _slots(self, params):
        return {"nu": _zeros(params, self.names)}

    def _direction(self, g, p, state, step):
        nu = [state.slots["nu"][n] for n in self.names]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.decay)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        return torch._foreach_mul(scale, g)


class AdadeltaRule(Rule):
    """optax ``scale_by_adadelta``: e_g = (1 - rho) g^2 + rho e_g,
    u = sqrt(e_x + eps) / sqrt(e_g + eps) g, e_x = (1 - rho) u^2 + rho
    e_x."""

    def __init__(self, names, *, rho: float, eps: float, **common):
        super().__init__(names, **common)
        self.rho, self.eps = rho, eps

    def _slots(self, params):
        return {"e_g": _zeros(params, self.names),
                "e_x": _zeros(params, self.names)}

    def _direction(self, g, p, state, step):
        e_g = [state.slots["e_g"][n] for n in self.names]
        e_x = [state.slots["e_x"][n] for n in self.names]
        torch._foreach_mul_(e_g, self.rho)
        torch._foreach_addcmul_(e_g, g, g, value=1 - self.rho)
        num = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        u = torch._foreach_div(num, den)
        torch._foreach_mul_(u, g)
        torch._foreach_mul_(e_x, self.rho)
        torch._foreach_addcmul_(e_x, u, u, value=1 - self.rho)
        return u


class AdagradRule(Rule):
    """optax ``scale_by_rss``: sos = g^2 + sos, u = g / sqrt(sos + eps)
    where sos > 0, else 0."""

    def __init__(self, names, *, initial: float, eps: float, **common):
        super().__init__(names, **common)
        self.initial, self.eps = initial, eps

    def _slots(self, params):
        return {"sum_of_squares": {
            n: torch.full_like(params[n], self.initial, dtype=torch.float32)
            for n in self.names}}

    def _direction(self, g, p, state, step):
        sos = [state.slots["sum_of_squares"][n] for n in self.names]
        torch._foreach_addcmul_(sos, g, g)
        out = []
        for s, x in zip(sos, g):
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                              torch.zeros_like(s))
            out.append(inv * x)
        return out


def _leaf_index(leaves, index):
    """Each leaf's positions among the rule's names."""
    return [[index[n] for n in leaf.names] for leaf in leaves]


def sum_squares(tensors) -> torch.Tensor:
    """The fp32 sum of squares of every element, ``torch.sum`` a tensor
    (accurate on the CPU, as ``global_norm`` says)."""
    parts = [torch.sum(torch.square(t.float())) for t in tensors]
    if not parts:
        return torch.zeros(())
    return torch.stack(parts).sum()


class LarsRule(Rule):
    """optax ``lars``: every parameter decays (the JAX package passes no
    pconfig mask), the update scales by the trust ratio
    ``trust_coefficient * |p| / (|u| + eps)`` of its JAX leaf (1 where
    either norm is 0), then by ``-lr``, then goes through the momentum
    trace."""

    def __init__(self, names, leaves, *, momentum: float, nesterov: bool,
                 eps: float, trust_coefficient: float = 0.001, **common):
        super().__init__(names, **common)
        self.leaves = leaves
        self.leaf_idx = _leaf_index(leaves, self.index)
        self.momentum, self.nesterov = momentum, nesterov
        self.eps, self.trust = eps, trust_coefficient

    def _slots(self, params):
        return {"trace": _zeros(params, self.names)}

    def _leaf_sum_sq(self, idx, ts) -> torch.Tensor:
        if not self.plan:
            return sum_squares([ts[i] for i in idx])
        return self.plan.sum_squares({self.names[i]: ts[i] for i in idx})

    def _direction(self, g, p, state, step):
        u = list(g)
        for idx in self.leaf_idx:
            p_norm = torch.sqrt(self._leaf_sum_sq(idx, p))
            u_norm = torch.sqrt(self._leaf_sum_sq(idx, g))
            ratio = self.trust * p_norm / (u_norm + self.eps)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(ratio), ratio)
            for i in idx:
                u[i] = g[i] * ratio
        return u

    def _apply(self, p, u, lr, state):
        u = torch._foreach_mul(u, -lr)
        t = [state.slots["trace"][n] for n in self.names]
        out = _trace(u, t, self.momentum, self.nesterov)
        live = self.live_idx
        torch._foreach_add_([p[i] for i in live], [out[i] for i in live])


def _factored_dims(shape, factored: bool, min_dim: int):
    """optax's choice: the two largest axes, or None when there are fewer
    than two or the second is under ``min_dim``."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class AdafactorRule(Rule):
    """The JAX package's Adafactor chain (optim/__init__.py:110-137 there):
    ``scale_by_factored_rms`` (factored over the two largest axes of each
    JAX leaf, the decay ``1 - (step + 1)^-decay_rate``), ``clip_by_block_rms``
    (``clipping_threshold``, per leaf), ``scale_by_param_block_rms`` (per
    leaf, the parameter's RMS floored at 1e-3), the optional momentum EMA
    kept in ``dtype_momentum``, then decoupled decay."""

    coupled = False

    def __init__(self, names, leaves, *, factored: bool, decay_rate: float,
                 min_dim_size_to_factor: int, eps: float,
                 clipping_threshold: Optional[float], param_scale: bool,
                 momentum: Optional[float], dtype_momentum, **common):
        super().__init__(names, **common)
        self.leaves = leaves
        self.leaf_idx = _leaf_index(leaves, self.index)
        self.factored, self.decay_rate = factored, decay_rate
        self.min_dim, self.eps = min_dim_size_to_factor, eps
        self.threshold = clipping_threshold
        self.param_scale = param_scale
        self.momentum = momentum
        self.dtype_momentum = dtype_momentum

    def _leaf_shape(self, leaf, params):
        parts = [params[n] for n in leaf.names]
        if self.plan:  # the whole leaf's shape, from its parts'
            parts = [torch.empty(self.plan.full_shape(n, t), device="meta")
                     for n, t in zip(leaf.names, parts)]
        return tuple(leaf.to_jax(parts).shape)

    def _whole(self, idx, ts) -> List[torch.Tensor]:
        """The whole tensors of the leaf at ``idx`` (every rank of a
        shard's group gathers it)."""
        if not self.plan:
            return [ts[i] for i in idx]
        return [self.plan.full(self.names[i], ts[i]) for i in idx]

    def _slots(self, params):
        slots = {"v_row": {}, "v_col": {}, "v": {}}
        for leaf in self.leaves:
            shape = self._leaf_shape(leaf, params)
            device = params[leaf.names[0]].device
            dims = _factored_dims(shape, self.factored, self.min_dim)
            if dims is None:
                slots["v"][leaf.key] = torch.zeros(shape, device=device)
            else:
                d1, d0 = dims
                slots["v_row"][leaf.key] = torch.zeros(
                    np.delete(shape, d0).tolist(), device=device)
                slots["v_col"][leaf.key] = torch.zeros(
                    np.delete(shape, d1).tolist(), device=device)
        if self.momentum is not None:
            slots["momentum"] = _zeros(params, self.names,
                                       self.dtype_momentum)
        return slots

    def _factored_rms(self, leaf, g, state, decay_t):
        slots = state.slots
        if leaf.key in slots["v"]:
            v = slots["v"][leaf.key]
            sq = g * g + self.eps
            v.copy_(decay_t * v + (1.0 - decay_t) * sq)
            return g * torch.pow(v, -0.5)
        d1, d0 = _factored_dims(tuple(g.shape), self.factored, self.min_dim)
        v_row, v_col = slots["v_row"][leaf.key], slots["v_col"][leaf.key]
        sq = g * g + self.eps
        v_row.copy_(decay_t * v_row + (1.0 - decay_t) * sq.mean(dim=d0))
        v_col.copy_(decay_t * v_col + (1.0 - decay_t) * sq.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
        row_factor = torch.pow(v_row / row_col_mean, -0.5)
        col_factor = torch.pow(v_col, -0.5)
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    def _direction(self, g, p, state, step):
        t = _f32(step + 1)
        decay_t = (1.0 - t ** (-self.decay_rate)).to(g[0].device)
        u = list(g)
        for leaf, idx in zip(self.leaves, self.leaf_idx):
            gj = leaf.to_jax(self._whole(idx, g))
            x = self._factored_rms(leaf, gj, state, decay_t)
            if self.threshold is not None:
                rms = torch.sqrt(torch.mean(x * x))
                x = x / torch.clamp(rms / self.threshold, min=1.0)
            if self.param_scale:
                pj = leaf.to_jax(self._whole(idx, p))
                rms = torch.sqrt(torch.mean(pj * pj))
                x = x * torch.clamp(rms, min=1e-3)
            for i, part in zip(idx, leaf.from_jax(x)):
                u[i] = (self.plan.local(self.names[i], part) if self.plan
                        else part)
        if self.momentum is not None:
            m = self.momentum
            for n, i in self.index.items():
                slot = state.slots["momentum"][n]
                # JAX casts the weakly typed decay to the slot's dtype; its
                # jitted step then multiplies in fp32 (XLA's excess
                # precision keeps the product unrounded)
                new = (1 - m) * u[i] + (torch.tensor(m, dtype=slot.dtype)
                                        * slot).float()
                slot.copy_(new)
                u[i] = new
        return u


class SplitRule:
    """AdamW_SGD (AdamW_SGD.py:38-138; the JAX package's multi_transform):
    the whole-model ``norm``/``value`` clip once, then each branch's rule on
    its own parameters with its own lr; one count for all."""

    def __init__(self, pre_clip: Optional[Dict], branches: List[Rule]):
        self.pre_clip = pre_clip
        self.branches = branches

    def init(self, params) -> OptState:
        slots: Dict[str, Dict[str, torch.Tensor]] = {}
        for b in self.branches:
            for name, slot in b._slots(params).items():
                slots.setdefault(name, {}).update(slot)
        return OptState(count=0, slots=slots)

    @torch.no_grad()
    def update_(self, grads, state: OptState, params,
                grad_norm: Optional[float] = None) -> None:
        clipped = {n: g.float() for n, g in grads.items()}
        if self.pre_clip:
            clipped = dict(zip(clipped, _whole_model_clip(
                self.pre_clip, list(clipped.values()), grad_norm)))
        for b in self.branches:
            b._step(clipped, state, params, None, state.count,
                    b.schedule(state.sched_count))
        state.sched_count += 1
        state.count += 1


def _scaled(schedule: Schedule, lr: float, base_lr: float) -> Schedule:
    """``schedule(step) * (lr / base_lr)`` in fp32, as JAX's
    ``scaled``."""
    ratio = np.float32(lr / base_lr)
    return lambda step: float(np.float32(schedule(step)) * ratio)


def _single(kind: str, kwargs: Dict, model: nn.Module, names: List[str],
            schedule: Schedule, labels: Dict[str, str], pconfig: Dict,
            grad_clip: Optional[Dict], frozen: List[str]) -> Rule:
    """One rule over ``names`` (the JAX package's ``_single_optimizer``)."""
    kind = _ALIASES.get(kind, kind)
    wd = float(kwargs.get("weight_decay", 0.0))
    decays: Dict[float, List[str]] = {}
    if kind == "LARS":  # optax.lars decays every parameter
        if wd:
            decays[wd] = list(names)
    else:
        for value, members in weight_decay_masks(labels, pconfig).items():
            rate = wd if value is None else value
            if rate and members:
                decays.setdefault(rate, []).extend(
                    n for n in names if n in members)
    max_norm = (float(kwargs["max_norm"]) if kind in (
        "AdamWithClip", "AdamWWithClip") and "max_norm" in kwargs else None)
    common = dict(decays=decays, grad_clip=grad_clip,
                  logit_names=[n for n in names
                               if labels[n] == "logit_scale"],
                  frozen=frozen, schedule=schedule, max_norm=max_norm)
    if kind == "SGD":
        return SGDRule(names, momentum=float(kwargs.get("momentum", 0.0)),
                       nesterov=bool(kwargs.get("nesterov", False)), **common)
    if kind in ("AdamW", "AdamWWithClip", "Adam", "AdamWithClip"):
        b1, b2 = kwargs.get("betas", (0.9, 0.999))
        return AdamRule(names, b1=float(b1), b2=float(b2),
                        eps=float(kwargs.get("eps", 1e-8)),
                        coupled=kind in ("Adam", "AdamWithClip"), **common)
    if kind == "RMSprop":
        return RMSpropRule(names, decay=float(kwargs.get("alpha", 0.99)),
                           eps=float(kwargs.get("eps", 1e-8)), **common)
    if kind == "Adadelta":
        return AdadeltaRule(names, rho=float(kwargs.get("rho", 0.9)),
                            eps=float(kwargs.get("eps", 1e-6)), **common)
    if kind == "Adagrad":
        return AdagradRule(
            names, initial=float(kwargs.get("initial_accumulator_value",
                                            0.0)),
            eps=float(kwargs.get("eps", 1e-10)), **common)
    if kind in ("LARS", "Adafactor"):
        from declip_tpu_torch.convert import jax_leaves

        leaves = [leaf for leaf in jax_leaves(model)
                  if leaf.names[0] in set(names)]
        if kind == "LARS":
            return LarsRule(names, leaves,
                            momentum=float(kwargs.get("momentum", 0.9)),
                            nesterov=bool(kwargs.get("nesterov", False)),
                            eps=float(kwargs.get("eps", 1e-8)), **common)
        threshold = kwargs.get("clipping_threshold", 1.0)
        momentum = kwargs.get("momentum")
        return AdafactorRule(
            names, leaves, factored=bool(kwargs.get("factored", True)),
            decay_rate=float(kwargs.get("decay_rate", 0.8)),
            min_dim_size_to_factor=int(kwargs.get("min_dim_size_to_factor",
                                                  128)),
            eps=float(kwargs.get("eps", 1e-30)),
            clipping_threshold=(None if threshold is None
                                else float(threshold)),
            param_scale=bool(kwargs.get("multiply_by_parameter_scale",
                                        True)),
            momentum=None if momentum is None else float(momentum),
            dtype_momentum=getattr(torch, str(kwargs.get("dtype_momentum",
                                                         "float32"))),
            **common)
    raise KeyError(f"unknown optimizer type {kind!r}")


def _is_text(name: str) -> bool:
    """The JAX package's text side of AdamW_SGD: a path with a component in
    ``_TEXT_PREFIXES`` (the port's ``encode_text`` is JAX's ``text``)."""
    parts = name.split(".")
    if parts[0] == "encode_text":
        parts[0] = "text"
    return any(part in _TEXT_PREFIXES for part in parts)


def optim_entry(cfg: Mapping, model: nn.Module, schedule: Schedule, *,
                pconfig: Optional[Dict] = None,
                grad_clip: Optional[Dict] = None,
                frozen_mask: Optional[Mapping[str, bool]] = None):
    """Build the update rule from an optimizer ``{type, kwargs}`` node for
    ``model``'s parameters: a ``Rule`` (or AdamW_SGD's ``SplitRule``) with
    ``init(params) -> OptState`` and ``update_(grads, state, params,
    grad_norm=None)``.

    frozen_mask: ``{parameter name: bool}``; True params get zero updates
    (the JAX analogue of ``requires_grad=False``, e.g. ViT's frozen conv1)."""
    kind = _ALIASES.get(cfg["type"], cfg["type"])
    kwargs = dict(cfg.get("kwargs") or {})
    pconfig = pconfig if pconfig is not None else cfg.get("pconfig") or {}
    kind_clip = (grad_clip or {}).get("type")
    if kind_clip in _CLIP_TYPES and "value" not in grad_clip:
        raise ValueError(f"grad_clip type {kind_clip!r} needs a value")
    labels = group_labels(model)
    names = list(labels)
    frozen = [n for n, f in (frozen_mask or {}).items() if f]
    if kind != "AdamW_SGD":
        return _single(kind, kwargs, model, names, schedule, labels,
                       pconfig, grad_clip, frozen)
    text_kw = dict(kwargs.get("text_config") or {})
    visual_kw = dict(kwargs.get("visual_config") or {})
    text_lr = text_kw.pop("lr", kwargs.get("lr", 1e-4))
    visual_lr = visual_kw.pop("lr", kwargs.get("lr", 1e-4))
    base_lr = kwargs.get("lr", 1.0) or 1.0
    pre, branch_clip = None, grad_clip
    if kind_clip in ("norm", "value"):
        pre, branch_clip = grad_clip, None
    text = [n for n in names if _is_text(n)]
    visual = [n for n in names if not _is_text(n)]
    return SplitRule(pre, [
        _single("AdamW", text_kw, model, text,
                _scaled(schedule, text_lr, base_lr), labels, pconfig,
                branch_clip, frozen),
        _single("SGD", visual_kw, model, visual,
                _scaled(schedule, visual_lr, base_lr), labels, pconfig,
                branch_clip, frozen)])


def fast_forward_schedule(opt_state: OptState, step: int) -> OptState:
    """Set ``opt_state``'s schedule count to ``step`` (port of
    declip_tpu/optim/__init__.py:225).

    Used by the reference-exact rollback mode (declip_solver.py:600-607):
    the reference rebuilds a FRESH optimizer after a crash (moments
    zeroed, bias correction restarted) but keeps evaluating its rebuilt
    scheduler at the current step. The rule's own ``count`` (Adam's bias
    correction, Adafactor's decay) is deliberately NOT touched: the
    reference restarts it."""
    opt_state.sched_count = int(step)
    return opt_state
