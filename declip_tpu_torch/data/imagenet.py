"""ImageNet train/test loader builders (the port's copy of
declip_tpu/data/imagenet.py; API parity with
prototype/data/imagenet_dataloader.py:153,218).

For supervised probing and linear eval on top of the towers, and as the
val-set feed for zero-shot evaluation when configs use the imagenet type.
"""

from __future__ import annotations

from typing import Dict

from declip_tpu_torch.data.dataloader import ClipDataLoader
from declip_tpu_torch.data.dataset import ImageNetDataset
from declip_tpu_torch.data.sampler import (
    DistributedEpochSampler,
    DistributedGivenIterationSampler,
    compute_total_iter,
)
from declip_tpu_torch.data.transforms import build_common_augmentation


def build_imagenet_train_dataloader(cfg: Dict, *, world_size: int = 1,
                                    rank: int = 0, last_iter: int = -1
                                    ) -> ClipDataLoader:
    aug = cfg.get("transforms", {}).get("type", "STANDARD")
    dataset = ImageNetDataset(
        root_dir=cfg.get("root_dir", ""),
        meta_file=cfg["meta_file"],
        transform=build_common_augmentation(aug),
        read_from=cfg.get("read_from", "fs"),
    )
    batch_size = int(cfg["batch_size"])
    total_iter = compute_total_iter(cfg, len(dataset), world_size)
    sampler_type = cfg.get("sampler", {}).get("type", "distributed_iteration")
    sampler_cls = (
        DistributedEpochSampler
        if sampler_type == "distributed_epoch"
        else DistributedGivenIterationSampler
    )
    sampler = sampler_cls(
        dataset_size=len(dataset), total_iter=total_iter,
        batch_size=batch_size, world_size=world_size, rank=rank,
        last_iter=last_iter,
    )
    return ClipDataLoader(
        dataset, sampler, batch_size,
        num_workers=int(cfg.get("num_workers", 4)),
    )


def build_imagenet_test_dataloader(cfg: Dict) -> ImageNetDataset:
    """The eval path returns the dataset; the solver batches it directly
    (sequential, the last batch padded)."""
    aug = cfg.get("transforms", {}).get("type", "ONECROP")
    return ImageNetDataset(
        root_dir=cfg.get("root_dir", ""),
        meta_file=cfg["meta_file"],
        transform=build_common_augmentation(aug),
        read_from=cfg.get("read_from", "fs"),
        label_texts_ensemble=cfg.get("label_texts_ensemble", "prompt80"),
    )
