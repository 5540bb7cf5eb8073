"""Deterministic, iteration-exact, resumable samplers (the port's copy of
declip_tpu/data/sampler.py; numpy only, the same index streams).

Rebuilds prototype/data/sampler.py. The key property the reference relies on
for exact resume (SURVEY.md §3.4): the ENTIRE ``total_iter x batch_size``
index stream is generated up-front from a fixed seed, each rank takes a
contiguous slab, and resume skips ``last_iter x batch_size`` indices
(sampler.py:57-106). We reproduce that contract with a lazily-evaluated
stream (the reference materializes the whole array — 128001x128 ints is fine,
but lazily chunking keeps startup instant for huge runs).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from declip_tpu_torch.utils.registry import SAMPLERS


class DistributedSampler:
    """Plain epoch sampler (sampler.py:8-54): one seeded permutation of the
    dataset per epoch, padded up to a multiple of world_size (round_up), each
    rank taking a contiguous slab. ``set_epoch`` reseeds the permutation.

    Delta: the reference permutes with torch.Generator; here numpy — the
    contract is "deterministic given epoch", not a specific stream."""

    def __init__(self, dataset_size: int, world_size: int = 1, rank: int = 0,
                 round_up: bool = True, **_unused):
        self.dataset_size = dataset_size
        self.world_size = world_size
        self.rank = rank
        self.round_up = round_up
        self.epoch = 0
        self.num_samples = -(-dataset_size // world_size)
        if round_up:
            self.total_size = self.num_samples * self.world_size
            self.length = self.num_samples
        else:
            self.total_size = dataset_size
            self.length = (self.num_samples
                           if rank < world_size - 1
                           else self.total_size
                           - (world_size - 1) * self.num_samples)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self.epoch)
        indices = rng.permutation(self.dataset_size)
        if self.round_up:
            pad = self.total_size - len(indices)
            if pad:
                indices = np.concatenate([indices, indices[:pad]])
        beg = self.num_samples * self.rank
        return iter(indices[beg:beg + self.num_samples].tolist())

    def __len__(self) -> int:
        return self.length


class DistributedGivenIterationSampler:
    """Per-rank index stream for exactly ``total_iter`` steps
    (sampler.py:57-106).

    ``orig_world_size``/``orig_batch_size``: world-size-elastic resume
    (beyond-reference — the reference's slabs are world-size-baked, so a
    run can only ever resume on the topology it started on). When a
    checkpoint saved at N hosts restores onto M, pass the ORIGINAL layout
    and this sampler reconstructs the original run's per-iteration GLOBAL
    batches and re-shards them rank-major onto the new topology — every
    global batch (and therefore the training trajectory under SPMD) is
    IDENTICAL to the uninterrupted original run. Requires the global batch
    to be conserved (new world x batch == orig world x batch)."""

    def __init__(self, dataset_size: int, total_iter: int, batch_size: int,
                 world_size: int = 1, rank: int = 0, last_iter: int = -1,
                 seed: int = 0, shuffle: bool = True,
                 orig_world_size: Optional[int] = None,
                 orig_batch_size: Optional[int] = None):
        self.dataset_size = dataset_size
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.world_size = world_size
        self.rank = rank
        self.last_iter = last_iter
        self.seed = seed
        self.shuffle = shuffle
        self.orig_world_size = int(orig_world_size or world_size)
        self.orig_batch_size = int(orig_batch_size or batch_size)
        self.total_size = total_iter * batch_size
        self.indices = self._gen_indices()
        self.call = 0

    def _gen_indices(self) -> np.ndarray:
        """Reference algorithm (sampler.py:81-104): seed(0), tile the dataset
        to world_size*total_size, shuffle globally, slice own slab. The
        elastic path builds the ORIGINAL topology's array and re-shards."""
        ow, ob = self.orig_world_size, self.orig_batch_size
        elastic = (ow, ob) != (self.world_size, self.batch_size)
        if elastic and ow * ob != self.world_size * self.batch_size:
            raise ValueError(
                f"elastic resume must conserve the global batch: original "
                f"{ow} x {ob} != new {self.world_size} x {self.batch_size}")
        gw, gb = (ow, ob) if elastic else (self.world_size, self.batch_size)
        per_rank = self.total_iter * gb
        rng = np.random.RandomState(self.seed)
        all_size = per_rank * gw
        indices = np.arange(self.dataset_size)
        indices = indices[:all_size]
        num_repeat = (all_size - 1) // indices.shape[0] + 1
        indices = np.tile(indices, num_repeat)[:all_size]
        if self.shuffle:
            rng.shuffle(indices)
        if not elastic:
            beg = self.total_size * self.rank
            return indices[beg:beg + self.total_size]
        # original layout: rank r's slab is contiguous; iteration t's global
        # batch is the rank-major concat of every rank's t-th slice
        global_batches = indices.reshape(gw, self.total_iter, gb) \
            .transpose(1, 0, 2).reshape(self.total_iter, gw * gb)
        mine = global_batches.reshape(
            self.total_iter, self.world_size, self.batch_size)[:, self.rank]
        return np.ascontiguousarray(mine).reshape(-1)

    def __iter__(self) -> Iterator[int]:
        start = (self.last_iter + 1) * self.batch_size
        return iter(self.indices[start:].tolist())

    def __len__(self) -> int:
        # reference returns the full slab regardless of resume (sampler.py:76-79)
        return self.total_size


class DistributedEpochSampler:
    """Epoch-aligned variant (sampler.py:109-169): each epoch's pass covers
    the dataset padded to a multiple of world*batch, reshuffled per epoch."""

    def __init__(self, dataset_size: int, total_iter: int, batch_size: int,
                 world_size: int = 1, rank: int = 0, last_iter: int = -1,
                 seed: int = 0):
        self.dataset_size = dataset_size
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.world_size = world_size
        self.rank = rank
        self.last_iter = last_iter
        self.seed = seed
        self.total_size = total_iter * batch_size
        self.indices = self._gen_indices()

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + epoch)
        idx = rng.permutation(self.dataset_size)
        per_round = self.batch_size * self.world_size
        pad = (-len(idx)) % per_round
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        # interleave: rank r takes rows r, r+W, ... in batch-sized chunks
        idx = idx.reshape(-1, per_round)
        beg = self.rank * self.batch_size
        return idx[:, beg:beg + self.batch_size].reshape(-1)

    def _gen_indices(self) -> np.ndarray:
        out: List[np.ndarray] = []
        n = 0
        epoch = 0
        while n < self.total_size:
            e = self._epoch_indices(epoch)
            out.append(e)
            n += len(e)
            epoch += 1
        return np.concatenate(out)[:self.total_size]

    def __iter__(self) -> Iterator[int]:
        start = (self.last_iter + 1) * self.batch_size
        return iter(self.indices[start:].tolist())

    def __len__(self) -> int:
        return self.total_size


class RankedGivenIterationSampler:
    """Per-rank-LOCAL index stream for ClipDatasetRanked (sampler.py:171-227):
    the dataset is already sharded across ranks at load time, so this sampler
    cycles a single shuffled permutation of the local indices for
    total_iter x batch_size draws (no reshuffle between passes) and resumes
    by fast-forwarding last_iter x batch_size positions. Delta: the reference
    draws its shuffle from the global numpy RNG; here a seed makes resume
    deterministic without relying on ambient RNG state."""

    def __init__(self, dataset_size: int, total_iter: int, batch_size: int,
                 last_iter: int = -1, seed: int = 0, shuffle: bool = True,
                 **_unused):
        self.dataset_size = dataset_size
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.last_iter = last_iter
        self.total_size = total_iter * batch_size
        self.indices = np.arange(dataset_size)
        if shuffle:
            np.random.RandomState(seed).shuffle(self.indices)

    def __iter__(self) -> Iterator[int]:
        start = (self.last_iter + 1) * self.batch_size
        for i in range(start, self.total_size):
            yield int(self.indices[i % self.dataset_size])

    def __len__(self) -> int:
        return self.total_size


@SAMPLERS.register(name="distributed")
def _build_distributed(**kw):
    # iteration-sampler kwargs that don't apply to the plain epoch sampler
    for k in ("total_iter", "batch_size", "last_iter", "seed"):
        kw.pop(k, None)
    return DistributedSampler(**kw)


@SAMPLERS.register(name="ranked_iteration")
def _build_ranked_iter(**kw):
    kw.pop("world_size", None)
    kw.pop("rank", None)
    return RankedGivenIterationSampler(**kw)


@SAMPLERS.register(name="distributed_iteration")
def _build_given_iter(**kw):
    return DistributedGivenIterationSampler(**kw)


@SAMPLERS.register(name="distributed_epoch")
def _build_epoch(**kw):
    return DistributedEpochSampler(**kw)


def compute_total_iter(cfg_data: dict, dataset_size: int, world_size: int
                       ) -> int:
    """max_iter from config, or derived from max_epoch
    (sampler.py:237-266's write-back, returned instead of mutating)."""
    if "max_iter" in cfg_data:
        return int(cfg_data["max_iter"])
    max_epoch = cfg_data["max_epoch"]
    batch = int(cfg_data["batch_size"])
    return int(max_epoch * dataset_size / (world_size * batch))
