"""Collectives of a data-parallel run (port of
declip_tpu/parallel/comms.py:22-86, over ``torch.distributed``).

Host objects: ``broadcast_object`` (the reference's pickle broadcast of
eval metrics, dist.py:111-126), ``gather_object`` (the eval merge, in rank
order: no shared filesystem needed), ``group_split`` (the contiguous rank
groups of grouped SyncBN, dist.py:39-46) and ``global_mean`` (the meters'
all-reduce, misc.py:38-40). Each returns the one-process value unchanged
without a group.

Tensors: ``all_reduce_``, ``all_gather`` (rank order), ``reduce_scatter``
(this rank's rows of the sum over ranks), ``broadcast_``, ``shift``
(the ring's hop: this rank's block to the next rank, the previous rank's
block here; ``lax.ppermute`` in the JAX package) and ``all_to_all``
(equal chunks, chunk i to rank i: MoE's expert parallelism), with
``AllToAll``, its differentiable form. NCCL runs each natively.
Under gloo, ``reduce_scatter`` is an all-reduce and a slice. gloo takes
CUDA tensors for the collectives (two ranks on one H100, PERF.md), but
PyTorch lists its point-to-point send and receive and its all-to-all for
CPU tensors only: ``shift`` and ``all_to_all`` stage a CUDA block through
host memory under gloo, and nothing else here does.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from declip_tpu_torch.parallel.dist import Group, data_group


def _group(group: Optional[Group]) -> Optional[Group]:
    return data_group() if group is None else group


def all_reduce_(t: torch.Tensor, group: Group, op: str = "sum"
                ) -> torch.Tensor:
    """In place over ``group``: the sum, or with ``op="mean"`` the mean."""
    import torch.distributed as dist

    dist.all_reduce(t, group=group.pg)
    if op == "mean":
        t.div_(group.size)
    elif op != "sum":
        raise ValueError(f"all_reduce op {op!r}: sum or mean")
    return t


def all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.pg)
    return torch.cat(parts)


def reduce_scatter(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``t`` [W*B, ...], this rank's rows [B, ...]
    of it."""
    import torch.distributed as dist

    t = t.contiguous()
    b = t.shape[0] // group.size
    if group.backend == "nccl":
        out = t.new_empty((b,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group.pg)
        return out
    # gloo has no reduce-scatter
    summed = all_reduce_(t.clone(), group)
    return summed[group.rank * b:(group.rank + 1) * b]


def broadcast_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` from rank 0, in place."""
    import torch.distributed as dist

    dist.broadcast(t, 0, group=group.pg)
    return t


def shift(t: torch.Tensor, group: Group, step: int = 1) -> torch.Tensor:
    """The ``t`` of rank ``rank - step`` of ``group`` (cyclic), while this
    rank's ``t`` goes to rank ``rank + step``: one send and one receive,
    posted together and in the same order on every rank."""
    import torch.distributed as dist

    w = group.size
    dst = group.ranks[(group.rank + step) % w]
    src = group.ranks[(group.rank - step) % w]
    staged = group.backend == "gloo" and t.is_cuda
    x = t.detach().contiguous()
    if staged:
        x = x.cpu()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group.pg),
           dist.P2POp(dist.irecv, out, src, group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if staged else out


def all_to_all(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` [W*C, ...] cut into W equal chunks along dim 0, chunk i sent
    to rank i of ``group``; -> [W*C, ...], chunk j the one rank j sent
    here."""
    import torch.distributed as dist

    staged = group.backend == "gloo" and t.is_cuda
    x = t.detach().contiguous()
    if staged:
        x = x.cpu()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.pg)
    return out.to(t.device) if staged else out


class AllToAll(torch.autograd.Function):
    """``all_to_all``, differentiable: its backward is the same exchange
    of the gradient's chunks (the permutation is its own transpose)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.group), None


def barrier(group: Optional[Group] = None) -> None:
    """Every rank of ``group`` (default: the data group) waits for the
    others; nothing without a group."""
    import torch.distributed as dist

    group = _group(group)
    if group is not None:
        dist.barrier(group=group.pg)


def broadcast_object(obj: Any, root: int = 0,
                     group: Optional[Group] = None) -> Any:
    """``obj`` of rank ``root``, on every rank (one process: itself)."""
    import torch.distributed as dist

    group = _group(group)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root, group=group.pg)
    return box[0]


def gather_object(obj: Any, group: Optional[Group] = None) -> List[Any]:
    """Every rank's ``obj``, in rank order (one process: ``[obj]``)."""
    import torch.distributed as dist

    group = _group(group)
    if group is None:
        return [obj]
    out: List[Any] = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out


def group_split(world_size: int, group_size: int) -> List[List[int]]:
    """Contiguous groups of ``group_size`` ranks (the reference's
    ``simple_group_split``, modified_resnet.py:121-142)."""
    if world_size % group_size:
        raise ValueError(f"a group of {group_size} ranks does not divide "
                         f"the world of {world_size}")
    return [list(range(i, i + group_size))
            for i in range(0, world_size, group_size)]


def global_mean(values: Sequence[float],
                group: Optional[Group] = None) -> np.ndarray:
    """The mean over ranks of each rank's host scalars."""
    arr = np.asarray(values, np.float64)
    group = _group(group)
    if group is None:
        return arr
    return np.mean(np.stack(gather_object(arr, group)), axis=0)
