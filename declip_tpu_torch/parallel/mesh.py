"""The rank groups of expert parallelism (port of
declip_tpu/parallel/mesh.py:61-121, ``make_mesh(..., ep=N)``: its
[data, expert] mesh, as groups of ranks).

``parallelism: {ep: N}``: adjacent ranks form an expert group of N, as
adjacent devices share an expert group on the JAX mesh, keeping the
dispatch all-to-alls on the shortest hops. The global batch shards over
every rank, so ``ep`` does not divide the data ways (the JAX solver's
``data_ways``, solver/__init__.py:186): the data group stays the world.
Expert ``e``'s ``wi``/``bi``/``wo``/``bo`` live on one rank of each
expert group, rank ``e // (E / N)`` of it, as the EP rules shard the
[E, ...] leaves over the ``expert`` axis (parallel/tp.py:83-91 there);
where ``E % N != 0`` the experts stay replicated, as ``_spec_for``
degrades an axis that does not divide (tp.py:105-119). The ranks at one
place of every expert group hold the same experts: ``expert_replicas``,
over which those experts' gradients are summed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from torch import nn

from declip_tpu_torch.parallel.dist import Group, new_group


@dataclass(frozen=True)
class Mesh:
    """``data``: every rank (None: one process); ``ep``: the size of an
    expert group; ``expert``: this rank's expert group; and
    ``expert_replicas``: the ranks that hold this rank's experts (None
    where the world is one expert group)."""

    data: Optional[Group]
    ep: int = 1
    expert: Optional[Group] = None
    expert_replicas: Optional[Group] = None


def make_mesh(group: Optional[Group], ep: int = 1) -> Mesh:
    """The mesh of a run over ``group`` (the data group) with expert
    groups of ``ep`` adjacent ranks. Every rank calls it, in the same
    order (it makes subgroups)."""
    ep = int(ep or 1)
    if ep <= 1:
        return Mesh(group)
    world = 1 if group is None else group.size
    if world % ep:
        raise ValueError(f"{world} ranks not divisible by expert={ep}")
    expert = replicas = None
    ways = world // ep
    for g in range(ways):
        sub = new_group(group.ranks[g * ep:(g + 1) * ep])
        if group.rank // ep == g:
            expert = sub
    if ways > 1:
        for i in range(ep):
            sub = new_group([group.ranks[g * ep + i] for g in range(ways)])
            if group.rank % ep == i:
                replicas = sub
    return Mesh(group, ep, expert, replicas)


def bind_experts(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Every MoE block of ``model`` whose experts divide over the expert
    group dispatches to their owners (``MoeMlpBlock.expert_group``); the
    others keep their experts replicated. ``parallel.fsdp.make_plan``
    then shards their expert parameters."""
    from declip_tpu_torch.models.layers import MoeMlpBlock

    for m in model.modules():
        if isinstance(m, MoeMlpBlock):
            m.expert_group = (mesh.expert if mesh.expert is not None
                              and m.num_experts % mesh.ep == 0 else None)
    return model
