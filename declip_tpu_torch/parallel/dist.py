"""The process group of a data-parallel run (port of
declip_tpu/parallel/mesh.py:166-185, ``maybe_initialize_distributed``; the
reference's linklink layer, SURVEY.md §1).

One process drives one card. The launcher says who this process is:

- torchrun (``python -m torch.distributed.run``): ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
- SLURM (``srun``): ``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``
  and ``SLURM_STEP_NODELIST`` (the first host of the step's node list is
  the rendezvous host, ``MASTER_PORT`` its port, 29500 by default);
- neither: one process, the world is 1 and no group is made.

The backend follows the device, NCCL for CUDA and gloo for the CPU; a
caller may name gloo on CUDA, which is how two ranks share one card in a
test (NCCL refuses two ranks on one device). The device defaults to
``cuda:LOCAL_RANK`` and a rank whose card does not exist raises. The init
has a timeout, so that a rank that never comes fails the run instead of
hanging it.

:class:`Group` is the handle the loss functions, BatchNorm and the train
step take as their ``axis_name``: the ranks a collective runs over. None
keeps meaning one process.
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

# a rank that has not joined after this long fails the init, and a
# collective that waits this long fails the run
DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Group:
    """A set of ranks that collectives run over, in rank order.

    ``pg``: the torch process group (None: the default group); ``ranks``:
    the global ranks, in the order gathers concatenate them; ``rank``: this
    process's index among them; ``backend``: ``nccl`` or ``gloo``."""

    pg: Any
    ranks: Tuple[int, ...]
    rank: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass
class _State:
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    backend: Optional[str] = None
    group: Optional[Group] = None


_STATE = _State()


def rank() -> int:
    """This process's rank in the world (0 with one process)."""
    return _STATE.rank


def world() -> int:
    """The number of processes (1 without a launcher)."""
    return _STATE.world


def local_rank() -> int:
    """This process's index on its host: the card it drives."""
    return _STATE.local_rank


def data_group() -> Optional[Group]:
    """The data-parallel group, every rank of the world; None without a
    process group."""
    return _STATE.group


def first_host(nodelist: str) -> str:
    """The first host of a SLURM node list: ``gpu[03-05,9],cpu1`` ->
    ``gpu03``."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if m is None:
        raise ValueError(f"cannot read the SLURM node list {nodelist!r}")
    prefix, ranges = m.group(1), m.group(2)
    if not ranges:
        return prefix
    return prefix + ranges.split(",")[0].split("-")[0]


def launch_env(env=None) -> Optional[dict]:
    """What the launcher says about this process: {rank, world,
    local_rank, addr, port}, or None without a launcher."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
                "local_rank": int(env.get("LOCAL_RANK", 0)),
                "addr": env.get("MASTER_ADDR", "127.0.0.1"),
                "port": int(env.get("MASTER_PORT", 29500))}
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodes = env.get("SLURM_STEP_NODELIST") or env.get(
            "SLURM_JOB_NODELIST", "127.0.0.1")
        return {"rank": int(env["SLURM_PROCID"]),
                "world": int(env["SLURM_NTASKS"]),
                "local_rank": int(env.get("SLURM_LOCALID", 0)),
                "addr": env.get("MASTER_ADDR") or first_host(nodes),
                "port": int(env.get("MASTER_PORT", 29500))}
    return None


def default_device(local: int) -> torch.device:
    """``cuda:<local>``, which must exist."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available here; pass --device cpu to run on the "
            "CPU")
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"local rank {local} has no card: this host has {n}; launch at "
            f"most {n} processes a host, or pass --device")
    return torch.device("cuda", local)


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the launcher's process group and return this rank's device.

    ``device``: None for ``cuda:LOCAL_RANK``, else the caller's (two ranks
    share a card only where the caller gives both the same one).
    ``backend``: None for NCCL on CUDA and gloo on the CPU. Without a
    launcher the world is 1, no group is made, and ``device`` defaults to
    ``cuda``. Called again in a process that has joined its group, it
    keeps that group and its backend and returns ``device``."""
    import torch.distributed as dist

    info = launch_env()
    if info is None:
        return torch.device(device or "cuda")
    device = (default_device(info["local_rank"]) if device is None
              else torch.device(device))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", info["local_rank"])
    if device.type == "cuda":
        if not torch.cuda.is_available() or \
                device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {info['rank']}: {device} does not "
                               f"exist here")
        torch.cuda.set_device(device)
    if dist.is_initialized():  # the group this process joined already
        backend = dist.get_backend()
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{info['addr']}:{info['port']}",
            world_size=info["world"], rank=info["rank"],
            timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.rank, _STATE.world = info["rank"], info["world"]
    _STATE.local_rank, _STATE.backend = info["local_rank"], backend
    _STATE.group = Group(None, tuple(range(info["world"])), info["rank"],
                         backend)
    return device


def new_group(ranks) -> Group:
    """A subgroup of ``ranks`` (global ranks, ascending). Every rank of the
    world must call it, for every subgroup, in the same order (torch's
    rule); a rank outside ``ranks`` gets a handle it must not use."""
    import torch.distributed as dist

    ranks = tuple(int(r) for r in ranks)
    pg = dist.new_group(list(ranks))
    me = ranks.index(_STATE.rank) if _STATE.rank in ranks else -1
    return Group(pg, ranks, me, _STATE.backend)


def shutdown() -> None:
    """Leave the process group (the end of a run)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.__init__()
