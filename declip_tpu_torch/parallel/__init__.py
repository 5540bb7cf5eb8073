"""Training over many processes (the port's counterpart of
declip_tpu/parallel): the process group (``dist``), its collectives
(``comms``), ZeRO-3 sharding of the train state (``fsdp``, ``parallelism:
{fsdp: true}``) and the expert groups of expert parallelism (``mesh``,
``parallelism: {ep: N}``). Not ported yet (ROADMAP.md item 1.10):
tensor and sequence parallelism (``tp``, ``sp``), the GPipe pipeline
(``pp``), multi-slice data parallelism (``slices``) and its hierarchical
ring, and ``{ep, fsdp}`` together; the solver raises on each."""

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
