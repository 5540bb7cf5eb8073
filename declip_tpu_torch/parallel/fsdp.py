"""FSDP (ZeRO-3) over the data group, and the expert shards of expert
parallelism (port of declip_tpu/parallel/fsdp.py, ``parallelism: {fsdp:
true}``; and of the EP placement, parallel/tp.py:83-91 there).

A :class:`ShardPlan` names the parameters of which each rank holds only a
part, its shard, and how that part was cut (:class:`Shard`). At rest the
model's parameter *is* the shard, a plain tensor, and so are its
optimizer slots and its EMA shadow (:func:`shard_train_state` cuts them
after the state is made). So the optimizer's elementwise rules, the EMA,
the logit-scale guard and the custom operators see plain tensors.

- FSDP (``kind`` ``fsdp``): every parameter of at least
  ``MIN_SHARD_SIZE`` elements, 1/W of it on each of the W ranks of the
  data group; smaller ones stay replicated, as the JAX package's
  ``MIN_SHARD_SIZE``, and so do BatchNorm's statistics, the NN bank,
  the MoCo queue and the key encoder (buffers and state, not
  parameters). The cut is dim 0 where W divides it, because a dim-0
  shard is contiguous and gathers with one all-gather and no copy;
  otherwise the largest divisible axis; otherwise the tensor stays
  replicated. The JAX package ranks axes by the TPU's (8, 128) tiles
  (``best_shard_axis``), which the card has not; the numbers do not
  depend on the axis. At world 1 nothing is sharded, as there.
  The step gathers the full parameters for the forward and backward by
  the port's differentiable gather (``ops.contrastive.gather_features``),
  whose backward reduce-scatters the gradient to the shards
  (:meth:`ShardPlan.gathered`); the train step divides it by W, the mean
  over the ranks.
- Expert parallelism (``kind`` ``expert``): a MoE block's ``wi``, ``bi``,
  ``wo`` and ``bo`` cut on dim 0 (the experts) over the rank's expert
  group (parallel/mesh.py), where the block dispatches to the owners
  (``models.layers.MoeMlpBlock``); the gradient is summed over the ranks
  that hold the same experts and divided by the world.

Everything that must see whole tensors takes them from the plan: a
checkpoint gathers them at save and cuts them at restore (the world-1
format: a run resumes at any world); the global gradient norm counts
each shard once and each replicated tensor once; Adafactor's and LARS's
per-leaf statistics are reduced over the shards (optim/__init__.py);
eval gathers every shard, without a graph.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from declip_tpu_torch.optim import sum_squares
from declip_tpu_torch.parallel import comms
from declip_tpu_torch.parallel.dist import Group

# below this many elements a parameter is replicated (fsdp.py there)
MIN_SHARD_SIZE = 2 ** 14

# optimizer slots keyed by JAX leaf, not by parameter (Adafactor's
# factored second moments): replicated
LEAF_SLOTS = ("v_row", "v_col", "v")


def shard_axis(shape: Tuple[int, ...], n: int) -> Optional[int]:
    """The axis to cut ``n`` ways: 0 where n divides it, else the largest
    divisible axis (the first on ties), else None."""
    if not shape:
        return None
    if shape[0] % n == 0:
        return 0
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and (best is None or d > shape[best]):
            best = i
    return best


@dataclass(frozen=True)
class Shard:
    """How a parameter is cut: ``kind`` (``fsdp`` or ``expert``), the
    axis ``dim``, the ``group`` of ranks that hold its parts (in group
    order), its ``full_shape``, and ``replicas``, the ranks that hold
    this same part (an expert shard's; None: no other)."""

    kind: str
    dim: int
    group: Group
    full_shape: Tuple[int, ...]
    replicas: Optional[Group] = None

    @property
    def size(self) -> int:
        return self.full_shape[self.dim] // self.group.size

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full`` (a view)."""
        return full.narrow(self.dim, self.group.rank * self.size, self.size)

    def gather(self, part: torch.Tensor,
               differentiable: bool = False) -> torch.Tensor:
        """The whole tensor from every rank's part; ``differentiable``:
        the backward reduce-scatters the gradient to the parts."""
        from declip_tpu_torch.ops.contrastive import gather_features

        x = part.movedim(self.dim, 0) if self.dim else part
        x = (gather_features(x, self.group) if differentiable
             else comms.all_gather(x.detach(), self.group))
        return x.movedim(0, self.dim) if self.dim else x


class ShardPlan:
    """The shards of ``model``'s parameters (by name) and what works on
    them."""

    def __init__(self, model: nn.Module, shards: Dict[str, Shard]):
        self.model = model
        self.shards = dict(shards)
        modules = dict(model.named_modules())
        self._owners = {}
        for name in self.shards:
            owner, _, attr = name.rpartition(".")
            self._owners[name] = (modules[owner], attr)
        self._gathered = False

    def __bool__(self) -> bool:
        return bool(self.shards)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``name``'s whole tensor (``full`` where
        ``name`` is replicated)."""
        shard = self.shards.get(name)
        if shard is None or tuple(full.shape) != shard.full_shape:
            return full
        return shard.local(full)

    def full(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """``name``'s whole tensor from this rank's ``part``, without a
        graph (every rank of its group calls it)."""
        shard = self.shards.get(name)
        if shard is None:
            return part
        return shard.gather(part)

    def full_shape(self, name: str, part: torch.Tensor) -> Tuple[int, ...]:
        shard = self.shards.get(name)
        return tuple(part.shape) if shard is None else shard.full_shape

    def sum_squares(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of squares of the whole tensors of ``named`` (parts of
        sharded ones): each replicated tensor counted once, each shard's
        squares summed over its group."""
        local = [t for n, t in named.items() if n not in self.shards]
        total = sum_squares(local)
        groups: Dict[Tuple[int, ...], Tuple[Group, list]] = {}
        for n, t in named.items():
            shard = self.shards.get(n)
            if shard is not None:
                groups.setdefault(shard.group.ranks,
                                  (shard.group, []))[1].append(t)
        for group, ts in groups.values():
            part = sum_squares(ts).to(ts[0].device)
            comms.all_reduce_(part, group)
            total = total.to(part.device) + part
        return total

    def global_norm(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sqrt(self.sum_squares(named))

    @contextlib.contextmanager
    def gathered(self, kinds: Tuple[str, ...] = ("fsdp",),
                 differentiable: bool = True):
        """The model's sharded parameters of ``kinds`` as whole tensors
        for the duration, gathered once: in a step with
        ``differentiable`` (the gradient reaches the parts through the
        gather's reduce-scatter, so run the backward inside), in eval
        without. A nested call is the outer one's."""
        names = [n for n, s in self.shards.items() if s.kind in kinds]
        if self._gathered or not names:
            yield self.model
            return
        saved = {}
        try:
            for n in names:
                module, attr = self._owners[n]
                part = module._parameters[attr]
                saved[n] = part
                module._parameters[attr] = self.shards[n].gather(
                    part, differentiable)
            self._gathered = True
            yield self.model
        finally:
            for n, part in saved.items():
                module, attr = self._owners[n]
                module._parameters[attr] = part
            self._gathered = False

    def resident_bytes(self, state) -> Dict[str, int]:
        """The bytes this rank holds of the parameters, the optimizer's
        parameter slots and the EMA shadow."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        opt = state.opt_state
        return {
            "params": nbytes(self.model.parameters()),
            "slots": nbytes(t for slot, ts in opt.slots.items()
                            if slot not in LEAF_SLOTS for t in ts.values()),
            "leaf_slots": nbytes(t for slot, ts in opt.slots.items()
                                 if slot in LEAF_SLOTS
                                 for t in ts.values()),
            "ema": nbytes((state.ema_params or {}).values())}


def make_plan(model: nn.Module, group: Optional[Group], *,
              fsdp: bool = False, mesh=None,
              min_size: int = MIN_SHARD_SIZE) -> ShardPlan:
    """The plan of ``model``'s parameters: with ``fsdp`` every large one
    over the data ``group``; with a ``mesh`` of expert groups
    (parallel/mesh.py, after ``bind_experts``) the expert parameters of
    each block that dispatches to their owners. ``fsdp`` with expert
    groups is not ported: the JAX package composes them through
    ``tp_fsdp_state_shardings``."""
    from declip_tpu_torch.models.layers import MoeMlpBlock

    shards: Dict[str, Shard] = {}
    expert = mesh is not None and mesh.expert is not None
    if fsdp and expert:
        raise NotImplementedError(
            "parallelism {ep, fsdp} together is not ported yet (the JAX "
            "package composes them through tp_fsdp_state_shardings; "
            "ROADMAP.md item 1.10)")
    if expert:
        for mname, m in model.named_modules():
            if isinstance(m, MoeMlpBlock) and m.expert_group is not None:
                for attr in ("wi", "bi", "wo", "bo"):
                    p = getattr(m, attr)
                    shards[f"{mname}.{attr}"] = Shard(
                        "expert", 0, m.expert_group, tuple(p.shape),
                        mesh.expert_replicas)
    if fsdp and group is not None and group.size > 1:
        for name, p in model.named_parameters():
            if p.numel() < min_size:
                continue
            dim = shard_axis(tuple(p.shape), group.size)
            if dim is not None:
                shards[name] = Shard("fsdp", dim, group, tuple(p.shape))
    return ShardPlan(model, shards)


def set_plan(tx, plan: Optional[ShardPlan]) -> None:
    """Give the update rule ``tx`` (a rule, or AdamW_SGD's split) the
    plan its whole-tensor statistics need."""
    for rule in getattr(tx, "branches", [tx]):
        rule.plan = plan if plan else None


@torch.no_grad()
def shard_train_state(state, plan: ShardPlan, tx=None):
    """Cut ``state`` (made whole, every rank the same) to this rank's
    parts, in place: the sharded parameters, their optimizer slots and
    their EMA shadow, each a new tensor so that the whole one is freed.
    Binds ``plan`` to the state (``state.shards``, which the train step
    and the checkpoints read) and to ``tx``."""
    if plan:
        for name, p in state.model.named_parameters():
            if name in plan.shards:
                p.data = plan.local(name, p.data).clone()
        for slot, tensors in state.opt_state.slots.items():
            if slot in LEAF_SLOTS:
                continue
            for n in list(tensors):
                tensors[n] = plan.local(n, tensors[n]).clone()
        if state.ema_params is not None:
            for n in list(state.ema_params):
                state.ema_params[n] = plan.local(
                    n, state.ema_params[n]).clone()
    state.shards = plan if plan else None
    if tx is not None:
        set_plan(tx, state.shards)
    return state
