"""Data-parallel training: the process group (``dist``) and its
collectives (``comms``); the port's counterpart of declip_tpu/parallel
(data parallelism only: the mesh's TP/SP/PP/EP/FSDP axes are not ported,
ROADMAP.md item 1.10)."""

from declip_tpu_torch.parallel.dist import (  # noqa: F401
    Group,
    data_group,
    init_distributed,
    local_rank,
    new_group,
    rank,
    shutdown,
    world,
)
