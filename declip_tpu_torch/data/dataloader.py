"""Batched, prefetching host data pipeline (the port's copy of
declip_tpu/data/dataloader.py; numpy, PIL and threads, no torch).

Replaces the reference's torch DataLoader + DataPrefetcher
(prototype/data/clip_dataloader.py, clip_solver.py:30-61) and moves the
host-side text work out of the model, as the JAX package does:

- BPE tokenization (reference: inside encode_text every step,
  text_transformer.py:185-188) -> tokenized here, batch carries int32 ids;
- EDA caption augmentation (reference: Python loop inside DECLIP.forward,
  declip.py:203-212) -> applied here, batch carries ``tokens_aug``;
- MLM masking (reference: per-sequence torch loop) -> vectorized numpy here.

Worker threads build whole batches; futures are consumed in submission order
so the INDEX stream is deterministic and exactly resumable (the reference's
resume contract, sampler.py:76-79). MLM masks and EDA draws are keyed by
(seed, global batch index, rank) so they replay exactly across resume
(``start_batch_idx`` continues the numbering); PIL image-crop draws are the
one non-replayed source, as in the reference and the JAX package. With the
same seeds and the same transform draws, the batches are the JAX loader's,
bit for bit. ``worker_type: process`` builds whole batches in spawned worker
processes with identical batch/keying semantics; the workers import no
torch kernels and never touch CUDA. A uint8 image batch (the geometry-only
crops of the on-device augmentation) stays uint8; CLSA's list of views
becomes ``images`` (the weak pair) and ``images_strong_{i}``, as in the
JAX loader. ``type: clip_wds`` reads
webdataset tar shards (data/wds.py).
"""

from __future__ import annotations

import itertools
import random
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from declip_tpu_torch.tokenizer import EDA, get_tokenizer, mask_tokens


# ---------------------------------------------------------- process workers
# ``worker_type: process`` moves whole-batch building into spawned worker
# processes: each worker REBUILDS the dataset from the config (hermetic — no
# pickling of live file handles), and batches come back as numpy arrays
# through the executor pipe. The deterministic keying (seed, global batch
# index) is identical in both modes. 'spawn' (not fork) is mandatory: the
# parent holds a CUDA context, which fork() would duplicate in a corrupt
# state; the data layer never touches CUDA, so spawned workers stay off the
# card.

_PROC_LOADER: Optional["ClipDataLoader"] = None


def _proc_init(spec: Dict[str, Any]) -> None:
    global _PROC_LOADER
    dataset = build_clip_dataset(
        spec["split_cfg"], world_size=spec["world_size"], rank=spec["rank"],
        transform=spec.get("transform"))
    _PROC_LOADER = ClipDataLoader(
        dataset, sampler=None, batch_size=spec["batch_size"],
        eda=spec["eda"], text_mask_type=spec["text_mask_type"],
        mlm_probability=spec["mlm_probability"], seed=spec["seed"],
        keep_raw=spec["keep_raw"], num_workers=1, rank=spec["rank"])


def _proc_build(indices: Sequence[int], batch_idx: int) -> Dict[str, Any]:
    return _PROC_LOADER._build_batch(indices, batch_idx)


class ClipDataLoader:
    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        *,
        tokenizer=None,
        context_length: int = 77,
        eda: bool = False,
        text_mask_type: Optional[str] = None,
        mlm_probability: float = 0.15,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        start_batch_idx: int = 0,
        drop_last: bool = True,
        keep_raw: bool = False,
        worker_type: str = "thread",
        proc_spec: Optional[Dict[str, Any]] = None,
        rank: int = 0,
    ):
        self.dataset = dataset
        self.rank = rank
        self.sampler = sampler
        self.batch_size = batch_size
        self.tokenizer = tokenizer or get_tokenizer()
        self.context_length = context_length
        self.eda = eda
        self.text_mask_type = text_mask_type
        self.mlm_probability = mlm_probability
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.start_batch_idx = start_batch_idx
        self.drop_last = drop_last
        self.keep_raw = keep_raw
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r} — thread|process")
        if worker_type == "process" and proc_spec is None:
            raise ValueError(
                "worker_type 'process' needs a proc_spec (a config the "
                "workers can rebuild the dataset from) — use "
                "build_clip_dataloader, or pass worker_type 'thread' for a "
                "directly-constructed dataset object")
        self.worker_type = worker_type
        self.proc_spec = proc_spec

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _build_batch(self, indices: Sequence[int], batch_idx: int
                     ) -> Dict[str, Any]:
        items = [self.dataset[i] for i in indices]
        strong: Dict[str, np.ndarray] = {}
        if isinstance(items[0]["image"], list):
            # CLSA's views (transforms.CLSAMultiResolutionTransform): the
            # two 224 px weak views on the channel axis of 'images', each
            # strong resolution its own images_strong_{i}
            images = np.stack([np.concatenate(it["image"][:2], axis=-1)
                               for it in items]).astype(np.float32)
            for v in range(2, len(items[0]["image"])):
                strong[f"images_strong_{v - 2}"] = np.stack(
                    [it["image"][v] for it in items]).astype(np.float32)
        else:
            images = np.stack([it["image"] for it in items])
            if images.dtype != np.uint8:  # uint8 = a geometry-only transform
                images = images.astype(np.float32)
        captions = [it["caption"] for it in items]
        labels = np.asarray([it["label"] for it in items], np.int32)

        tok = self.tokenizer
        batch: Dict[str, Any] = {
            "images": images,
            "tokens": tok.tokenize(captions, self.context_length),
            "labels": labels,
            **strong,
        }
        # the draws are keyed by the rank too, so that ranks do not share
        # them; rank 0's are the one-process run's
        if self.eda:
            eda = EDA(seed=self.seed * 1_000_003 + batch_idx
                      + (self.rank << 40))
            batch["tokens_aug"] = tok.tokenize(
                eda.augment_batch(captions), self.context_length
            )
        if self.text_mask_type is not None:
            rng = np.random.default_rng(
                (self.seed, 7, batch_idx) + ((self.rank,) if self.rank
                                             else ()))
            mlm_tokens, mlm_labels = mask_tokens(
                batch["tokens"],
                mask_id=tok.mask_id,
                vocab_size=tok.vocab_size,
                special_ids=(tok.sot_id, tok.eot_id, tok.mask_id),
                rng=rng,
                mlm_probability=self.mlm_probability,
            )
            batch["mlm_tokens"] = mlm_tokens
            batch["mlm_labels"] = mlm_labels.astype(np.int32)
        if self.keep_raw:
            batch["captions"] = captions
            batch["filenames"] = [it["filename"] for it in items]
            batch["label_names"] = [it["label_name"] for it in items]
            batch["image_ids"] = [it["image_id"] for it in items]
            batch["tags"] = [it["tag"] for it in items]
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        index_iter = iter(self.sampler)

        def batches_of_indices():
            i = self.start_batch_idx  # continues MLM/EDA keying over resume
            while True:
                chunk = list(itertools.islice(index_iter, self.batch_size))
                if not chunk:
                    return
                if len(chunk) < self.batch_size and self.drop_last:
                    return
                yield i, chunk
                i += 1

        if self.worker_type == "process":
            import multiprocessing

            pool_cm = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_proc_init, initargs=(self.proc_spec,))
            build = _proc_build
        else:
            pool_cm = ThreadPoolExecutor(self.num_workers)
            build = self._build_batch
        with pool_cm as pool:
            inflight: deque = deque()
            gen = batches_of_indices()
            try:
                for _ in range(self.num_workers + self.prefetch):
                    i, chunk = next(gen)
                    inflight.append(pool.submit(build, chunk, i))
            except StopIteration:
                pass
            try:
                while inflight:
                    out = inflight.popleft().result()
                    try:
                        i, chunk = next(gen)
                        inflight.append(pool.submit(build, chunk, i))
                    except StopIteration:
                        pass
                    yield out
            finally:
                # closed early (the run ended or rolled back): batches not
                # started yet are dropped, not built
                for f in inflight:
                    f.cancel()


def build_clip_dataset(split_cfg: Dict, *, world_size: int = 1, rank: int = 0,
                       transform=None):
    """Dataset half of prototype/data/clip_dataloader.py:66-120: transform
    preset, image-reader selection, metadata-server mode, and the
    ``use_ranked`` switch to the rank-pre-sharded dataset
    (clip_dataloader.py:86-90)."""
    from declip_tpu_torch.data.dataset import (
        ClipDataset,
        ClipDatasetRanked,
        ImageNetDataset,
    )
    from declip_tpu_torch.data.transforms import (
        build_common_augmentation,
        build_transformer,
    )

    image_reader = split_cfg.get("image_reader") or {}
    if transform is None:
        tcfg = split_cfg.get("transforms", {})
        if isinstance(tcfg, (list, tuple)):
            # list-style custom pipelines (clip_dataloader.py:75-78)
            transform = build_transformer(tcfg, image_reader)
        else:
            transform = build_common_augmentation(
                tcfg.get("type", "ONECROP"))
    if split_cfg.get("type") == "clip_wds":
        # webdataset tar shards: ``tar_files`` (or meta_file) carries the
        # shard spec; root_dir, read_from and fseek do not apply
        from declip_tpu_torch.data.wds import WdsClipDataset

        return WdsClipDataset(
            tar_files=split_cfg.get("tar_files", split_cfg.get("meta_file")),
            transform=transform,
            caption_key=split_cfg.get("caption_key", "caption"),
            label_texts_ensemble=split_cfg.get("label_texts_ensemble",
                                               "none"),
            image_reader_type=image_reader.get("type", "pil"),
            native_min_side=int(image_reader.get("min_side", 512)),
        )
    read_from = split_cfg.get("read_from", "fs")
    common = dict(
        root_dir=split_cfg.get("root_dir", ""),
        meta_file=split_cfg.get("meta_file", "1024"),
        transform=transform,
        read_from=read_from,
        fseek=split_cfg.get("fseek", False),
        image_reader_type=image_reader.get("type", "pil"),
        native_min_side=int(image_reader.get("min_side", 512)),
        server_cfg=split_cfg.get("server_cfg") or None,
        label_texts_ensemble=split_cfg.get("label_texts_ensemble", "none"),
    )
    if split_cfg.get("type", "clip") == "imagenet" and read_from != "synthetic":
        common.pop("server_cfg")
        return ImageNetDataset(**common)
    if split_cfg.get("use_ranked", False):
        return ClipDatasetRanked(world_size=world_size, rank=rank, **common)
    return ClipDataset(**common)


def build_sampler(split_cfg: Dict, dataset_size: int, *, world_size: int = 1,
                  rank: int = 0, last_iter: int = -1,
                  total_iter: Optional[int] = None):
    """Sampler half of the reference builder (sampler.py:237-266):
    ``sampler.type`` dispatch through the SAMPLERS registry; ``use_ranked``
    forces the local ranked sampler (clip_dataloader.py:88-90)."""
    from declip_tpu_torch.data.sampler import compute_total_iter
    from declip_tpu_torch.utils.registry import SAMPLERS

    scfg = dict(split_cfg.get("sampler") or {})
    stype = scfg.get("type", "distributed_iteration")
    if split_cfg.get("use_ranked", False):
        stype = "ranked_iteration"
    if total_iter is None and stype != "distributed":
        total_iter = compute_total_iter(split_cfg, dataset_size, world_size)
    kwargs = dict(scfg.get("kwargs") or {})
    kwargs.update(
        dataset_size=dataset_size,
        world_size=world_size,
        rank=rank,
    )
    if stype != "distributed":
        seed = int(split_cfg.get("seed", 0))
        kwargs.update(
            total_iter=total_iter,
            batch_size=int(split_cfg["batch_size"]),
            last_iter=last_iter,
            seed=seed + rank if stype == "ranked_iteration" else seed,
        )
    elif total_iter is not None or "max_iter" in split_cfg or \
            "max_epoch" in split_cfg:
        # the plain epoch sampler yields ONE epoch per pass (reference
        # sampler.py:8-54 behaves identically): a train run wanting more
        # iterations stops at the epoch boundary. Warn loudly — the
        # iteration samplers are the right tool for multi-epoch training.
        import logging

        want = total_iter if total_iter is not None else compute_total_iter(
            split_cfg, dataset_size, world_size)
        one_epoch = -(-dataset_size //
                      (world_size * int(split_cfg.get("batch_size", 1))))
        if want > one_epoch:
            logging.getLogger("declip_tpu_torch").warning(
                "sampler.type=distributed yields a single epoch (~%d steps) "
                "per pass but the config asks for %d iterations; training "
                "will stop at the epoch boundary. Use "
                "'distributed_iteration' or 'distributed_epoch' for "
                "multi-epoch runs.", one_epoch, want)
    return SAMPLERS.get(stype)(**kwargs)


def build_clip_dataloader(split_cfg: Dict, *, world_size: int = 1,
                          rank: int = 0, last_iter: int = -1,
                          total_iter: Optional[int] = None,
                          keep_raw: bool = False,
                          dataset=None, transform=None) -> ClipDataLoader:
    """Config-driven builder mirroring prototype/data/clip_dataloader.py:66.

    split_cfg carries the reference keys: batch_size, num_workers,
    {root_dir, meta_file, read_from, fseek}, transforms {type},
    image_reader {type, min_side}, server_cfg, use_ranked, sampler
    {type, kwargs}, and the DeCLIP extras (eda/text_mask_type flow from the
    model config through the solver). Pass ``dataset=`` to reuse an already
    built dataset (the Solver rebuilds loaders on resume/rollback without
    re-scanning metafiles) and ``transform=`` to override the preset (the
    on-device-augmentation path swaps in geometry-only crops)."""
    if dataset is None:
        dataset = build_clip_dataset(
            split_cfg, world_size=world_size, rank=rank, transform=transform)
    sampler = build_sampler(
        split_cfg, len(dataset), world_size=world_size, rank=rank,
        last_iter=last_iter, total_iter=total_iter)
    worker_type = str(split_cfg.get("worker_type", "thread"))
    proc_spec = None
    if worker_type == "process":
        # workers rebuild the dataset hermetically from this spec (even
        # when a pre-built ``dataset`` was passed for sampler sizing / the
        # Solver's resume rebuilds) — everything here must pickle: plain
        # config plus the optional transform override (our transform
        # classes are stateless PIL pipelines and pickle fine)
        proc_spec = dict(
            split_cfg=dict(split_cfg), world_size=world_size, rank=rank,
            transform=transform,
            batch_size=int(split_cfg["batch_size"]),
            eda=bool(split_cfg.get("eda", False)),
            text_mask_type=split_cfg.get("text_mask_type"),
            mlm_probability=float(split_cfg.get("mlm_probability", 0.15)),
            seed=int(split_cfg.get("seed", 0)),
            keep_raw=keep_raw,
        )
    return ClipDataLoader(
        dataset,
        sampler,
        int(split_cfg["batch_size"]),
        eda=bool(split_cfg.get("eda", False)),
        text_mask_type=split_cfg.get("text_mask_type"),
        num_workers=int(split_cfg.get("num_workers", 4)),
        seed=int(split_cfg.get("seed", 0)),
        start_batch_idx=last_iter + 1,
        keep_raw=keep_raw,
        worker_type=worker_type,
        proc_spec=proc_spec,
        rank=rank,
    )
