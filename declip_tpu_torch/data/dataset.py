"""Datasets: image-text pairs (JSONL metafile) and ImageNet eval (the
port's copy of declip_tpu/data/dataset.py; PIL and numpy).

Rebuilds prototype/data/datasets/{clip_dataset,imagenet_dataset,
base_dataset}.py:

- ClipDataset: JSONL metafile lines ``{"filename", "caption"[, "label",
  "label_name", "tag"]}`` over one or more (root, meta) pairs; in-RAM or
  fseek byte-offset modes (clip_dataset.py:66-91,141-154); rejects empty /
  Chinese captions and decode failures by resampling a random index
  (clip_dataset.py:180-216); zero-shot prompt machinery
  (clip_dataset.py:238-288).
- ImageNetDataset: "filename label" metafile (imagenet_dataset.py:22-98).
- ClipDatasetRanked: the rank-pre-sharded variant.
- Storage backends: fs bytes, 'fake' (one cached file served for every
  sample, base_dataset.py:81-86), and 'synthetic' (procedural images, no
  files at all, the same images as the JAX package's).

Image readers: PIL, or ``image_reader: {type: native, min_side}``, the C++
libjpeg decoder (data/native.py) with DCT prescale to ``min_side`` (512 by
default, as in JAX). Bytes that are not a JPEG (by their magic bytes) go
to PIL, as in JAX. A JPEG that libjpeg rejects (CMYK, a decode error) also
goes to PIL, as in JAX, and is counted in the dataset's
``native_fallbacks`` (the first one is logged). Unlike JAX, a native
library that cannot be built raises when the dataset is built, with the
compiler's message, instead of sending every image to PIL.

Not in the port yet, each raising ``NotImplementedError`` (ROADMAP.md item
1.7a.5) rather than reading something else: Google Cloud Storage
(``read_from: gcs``, ``gs://`` metafiles), the reference's mc/ceph/petrel
stores and the HTTP metadata server (``server_cfg``).
"""

from __future__ import annotations

import io
import json
import logging
import os.path as osp
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from declip_tpu_torch.utils.registry import DATASETS

_log = logging.getLogger(__name__)

PROMPT_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "prompts")


def pil_loader(data: bytes) -> Image.Image:
    """bytes -> RGB, truncated-image tolerant (image_reader.py:12-20)."""
    from PIL import ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image.open(io.BytesIO(data)).convert("RGB")


from functools import lru_cache


@lru_cache(maxsize=32)
def _synthetic_base(label: Optional[int], size: int) -> np.ndarray:
    rng = np.random.default_rng(0 if label is None else 1000 + label)
    return rng.integers(0, 255, size=(size, size, 3)).astype(np.int16)


@lru_cache(maxsize=64)
def _synthetic_noise(slot: int, size: int) -> np.ndarray:
    return np.random.default_rng(10_000 + slot).normal(
        0, 30, size=(size, size, 3)).astype(np.int16)


@lru_cache(maxsize=2048)
def _synthetic_composed(idx: int, label: Optional[int], size: int
                        ) -> np.ndarray:
    base = _synthetic_base(label, size)
    noise = np.roll(_synthetic_noise(idx % 64, size), idx // 64, axis=0)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _synthetic_image(idx: int, label: Optional[int] = None,
                     size: int = 256) -> Image.Image:
    """Procedural image; samples of one label share a base pattern (so toy
    runs have learnable signal), with per-sample noise on top.

    Rendered arrays are cached — numpy RNG and elementwise composition hold
    the GIL, which serialized the loader's worker threads (bottlenecked an
    e2e bench at ~68 img/s before caching)."""
    return Image.fromarray(_synthetic_composed(idx, label, size), "RGB")


def contains_chinese(s: str) -> bool:
    return any("一" <= ch <= "龥" for ch in s)


_JPEG_MAGIC = b"\xff\xd8"
_UNPORTED_STORES = ("gcs", "mc", "ceph", "petrel")
_STORES = ("fs", "fake", "synthetic")
_READERS = ("pil", "native")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md item 1.7a.5); the port reads "
        f"local files (read_from: fs or fake) and synthetic images")


def check_image_reader(image_reader_type: str) -> None:
    """Refuse a reader the port lacks; build the native library now (it
    raises with the compiler's message) so that no image falls back."""
    if image_reader_type not in _READERS:
        raise NotImplementedError(
            f"image_reader type {image_reader_type!r}: the port decodes with "
            f"{' or '.join(_READERS)} (the reference's kestrel decoder is "
            f"SenseTime hardware and not ported)")
    if image_reader_type == "native":
        from declip_tpu_torch.data import native

        native.load()


def _check_store(read_from: str, metas: Sequence, server_cfg,
                 image_reader_type: str) -> None:
    if read_from in _UNPORTED_STORES:
        raise _not_ported(f"read_from: {read_from}")
    if read_from not in _STORES:
        raise ValueError(f"read_from {read_from!r}: one of {_STORES}")
    if any(str(m).startswith("gs://") for m in metas):
        raise _not_ported("a gs:// metafile")
    if server_cfg:
        raise _not_ported("the HTTP metadata server (server_cfg)")
    check_image_reader(image_reader_type)


class ClipDataset:
    """Image-text pairs with prompt-ensemble zero-shot support."""

    # JPEGs the native decoder rejected (CMYK, a libjpeg error), decoded
    # with PIL instead; counted per dataset, the first one logged
    native_fallbacks = 0

    def __init__(
        self,
        root_dir,
        meta_file,
        transform=None,
        read_from: str = "fs",
        fseek: bool = False,
        label_texts_ensemble: str = "none",
        evaluator=None,
        image_reader_type: str = "pil",
        native_min_side: int = 512,
        server_cfg=None,
        seed: int = 0,
    ):
        roots = root_dir if isinstance(root_dir, (list, tuple)) else [root_dir]
        metas = meta_file if isinstance(meta_file, (list, tuple)) else [meta_file]
        _check_store(read_from, metas, server_cfg, image_reader_type)
        self.read_from = read_from
        self.fseek = fseek
        self.transform = transform
        self.label_texts_ensemble = label_texts_ensemble
        self.evaluator = evaluator
        self.image_reader_type = image_reader_type
        self.native_min_side = native_min_side
        self._fake_bytes: Optional[bytes] = None
        self._rng = random.Random(seed)

        self.roots: List[str] = []
        self.metas: List[Dict] = []
        self._offsets: List[Tuple[str, int]] = []  # (meta_path, byte offset)
        self.num = 0

        assert len(roots) == len(metas)
        for root, meta in zip(roots, metas):
            if read_from == "synthetic":
                n = int(meta)  # meta carries the synthetic sample count
                n_cls = 10
                for i in range(n):
                    self.metas.append(
                        {"filename": f"synthetic_{i}.png",
                         "caption": f"a photo of pattern {i % n_cls}",
                         "label": i % n_cls,
                         "label_name": f"pattern {i % n_cls}"}
                    )
                    self.roots.append(root or "")
                self.num += n
                continue
            if fseek:
                with open(meta, "rb") as f:
                    offset = 0
                    for line in f:
                        if line.strip():
                            self._offsets.append((meta, offset))
                            self.roots.append(root)
                        offset += len(line)
                self.num = len(self._offsets)
            else:
                with open(meta) as f:
                    for line in f:
                        if line.strip():
                            self.metas.append(json.loads(line))
                            self.roots.append(root)
                self.num = len(self.metas)

    def __len__(self) -> int:
        return self.num

    def _meta(self, idx: int) -> Dict:
        if self.fseek and self.read_from != "synthetic":
            path, off = self._offsets[idx]
            with open(path, "rb") as f:
                f.seek(off)
                return json.loads(f.readline())
        return self.metas[idx]

    def _read_bytes(self, filename: str) -> bytes:
        if self.read_from == "fake":
            # single cached file served for every sample
            # (base_dataset.py:81-86) — data-pipeline throughput testing;
            # cached per INSTANCE (train and eval datasets may point at
            # different files)
            if self._fake_bytes is None:
                with open(filename, "rb") as f:
                    self._fake_bytes = f.read()
            return self._fake_bytes
        with open(filename, "rb") as f:
            return f.read()

    def _load_image(self, idx: int, meta: Dict) -> Image.Image:
        if self.read_from == "synthetic":
            return _synthetic_image(idx, meta.get("label"))
        path = osp.join(self.roots[idx], meta["filename"])
        return self._decode(self._read_bytes(path))

    def _decode(self, data: bytes) -> Image.Image:
        if self.image_reader_type == "native":
            # C++ libjpeg decode with DCT prescale to native_min_side (the
            # short side; RandomResizedCrop's scale >= 0.2 keeps crops above
            # the decode resolution). Pixel-based crops (RandomCropMinSize,
            # STANDARD_CLIP) see a wider field of view on a prescaled decode:
            # min_side 0 decodes at full resolution. Bytes that are not a
            # JPEG go to PIL, as in JAX; a JPEG that native rejects goes to
            # PIL too (JAX's result) but is counted in native_fallbacks.
            from declip_tpu_torch.data import native

            if data[:2] == _JPEG_MAGIC:
                try:
                    return Image.fromarray(native.decode_jpeg(
                        data, min_side=self.native_min_side), "RGB")
                except ValueError:
                    self.native_fallbacks += 1
                    if self.native_fallbacks == 1:
                        _log.warning(
                            "image_reader native: libjpeg rejected a JPEG "
                            "(CMYK or corrupt); decoding it with PIL, and "
                            "counting such images in native_fallbacks")
        return pil_loader(data)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        """Returns {'image': HWC float32 (or PIL if no transform),
        'caption': str, 'label': int, ...}. On any decode/caption failure,
        resamples a random index (clip_dataset.py:211-216)."""
        for _ in range(64):
            try:
                meta = self._meta(idx)
                caption = meta.get("caption", "")
                if isinstance(caption, list):
                    caption = caption[0] if caption else ""
                if not caption or contains_chinese(caption):
                    raise ValueError("bad caption")
                img = self._load_image(idx, meta)
                if self.transform is not None:
                    img = self.transform(img)
                return {
                    "image": img,
                    "caption": caption,
                    "label": int(meta.get("label", -1)),
                    "label_name": meta.get("label_name", ""),
                    "filename": meta.get("filename", ""),
                    "tag": meta.get("tag", ""),
                    "image_id": idx,
                }
            except Exception:
                idx = self._rng.randrange(self.num)
        raise RuntimeError("64 consecutive bad samples — check the dataset")

    # ---- zero-shot prompt machinery (clip_dataset.py:238-288) ------------
    def _get_label_text(self, text: str) -> List[str]:
        ens = self.label_texts_ensemble
        if ens == "cc":
            return [text]
        if ens == "none":
            return [f"a photo of {text}."]
        named = {"prompt6": "query_pattern_prompt6",
                 "prompt8": "query_pattern_prompt8",
                 "prompt80": "query_pattern_prompt80",
                 "simple": "query_pattern_prompt1"}
        if ens in named:
            path = osp.join(PROMPT_DIR, named[ens])
        elif ens.startswith("file:"):
            path = ens[5:]
        else:
            raise NotImplementedError(ens)
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return [ln.replace("{0}", text) for ln in lines]

    def label_mapping(self) -> Dict[int, str]:
        mapping: Dict[int, str] = {}
        n = len(self)
        for i in range(n):
            meta = self._meta(i)
            if "label" in meta and "label_name" in meta:
                mapping[int(meta["label"])] = meta["label_name"]
        return mapping

    def get_label_texts(self):
        """classes x prompts texts + identity ensemble matrix
        (clip_dataset.py:260-288)."""
        mapping = self.label_mapping()
        labels = sorted(mapping)
        label_texts: List[str] = []
        for lbl in labels:
            label_texts.extend(self._get_label_text(mapping[lbl]))
        matrix = np.eye(len(labels), dtype=np.float32)
        return label_texts, matrix


@DATASETS.register(name="clip")
def build_clip_dataset(**kwargs) -> ClipDataset:
    return ClipDataset(**kwargs)


class ImageNetDataset(ClipDataset):
    """'filename label' whitespace metafile (imagenet_dataset.py:22-98),
    served through the ClipDataset item interface with caption ''."""

    def __init__(self, root_dir, meta_file, transform=None, read_from="fs",
                 evaluator=None, label_texts_ensemble="none", seed=0,
                 class_names: Optional[Sequence[str]] = None, fseek=False,
                 image_reader_type="pil", native_min_side=512, **_):
        _check_store(read_from, [meta_file], None, image_reader_type)
        self.read_from = read_from
        # the line-offset machinery is JSONL-specific; for the whitespace
        # metafile the parsed metas are small, so fseek only skips keeping
        # them resident — honored by parsing lazily below
        self.fseek = False
        self.transform = transform
        self.label_texts_ensemble = label_texts_ensemble
        self.evaluator = evaluator
        self.image_reader_type = image_reader_type
        self.native_min_side = native_min_side
        self._fake_bytes = None
        self._rng = random.Random(seed)
        self.roots = []
        self.metas = []
        self._offsets = []
        self._class_names = class_names
        self._imagenet_fseek = bool(fseek)
        with open(meta_file) as f:
            for line in f:
                parts = line.strip().rsplit(maxsplit=1)
                if not parts:
                    continue
                filename, label = parts[0], int(parts[1])
                if self._imagenet_fseek:
                    # keep the two parsed fields, build the dict on demand
                    self.metas.append((filename, label))
                else:
                    meta = {"filename": filename, "label": label,
                            "caption": "-"}
                    if class_names is not None:
                        meta["label_name"] = class_names[label]
                    self.metas.append(meta)
                self.roots.append(root_dir)
        self.num = len(self.metas)

    def _meta(self, idx: int) -> Dict:
        if not self._imagenet_fseek:
            return self.metas[idx]
        filename, label = self.metas[idx]
        meta = {"filename": filename, "label": label, "caption": "-"}
        if self._class_names is not None:
            meta["label_name"] = self._class_names[label]
        return meta

    def __getitem__(self, idx):
        meta = self._meta(idx)
        img = self._load_image(idx, meta)
        if self.transform is not None:
            img = self.transform(img)
        return {
            "image": img,
            "caption": meta.get("caption", "-"),
            "label": int(meta.get("label", -1)),
            "label_name": meta.get("label_name", ""),
            "filename": meta.get("filename", ""),
            "tag": "",
            "image_id": idx,
        }


@DATASETS.register(name="imagenet")
def build_imagenet_dataset(**kwargs) -> ImageNetDataset:
    return ImageNetDataset(**kwargs)


class ClipDatasetRanked(ClipDataset):
    """Rank-pre-sharded variant (clip_dataset.py:314-464): a seeded hash
    assigns each metadata line to one rank at load time, every rank pads to
    the global max count by resampling its own lines. Avoids each worker
    scanning the full metafile on huge datasets.

    Delta: the reference uses ``random.randint`` under a fixed seed plus an
    allgather for padding (clip_dataset.py:404-422); here assignment is a
    deterministic stable hash of the line index so no collective is needed
    (every rank can compute every rank's count).
    """

    def __init__(self, *args, world_size: int = 1, rank: int = 0, **kwargs):
        self.world_size = world_size
        self.rank = rank
        super().__init__(*args, **kwargs)
        if world_size <= 1:
            return
        owner = [(i * 2654435761) % world_size for i in range(self.num)]
        mine = [i for i in range(self.num) if owner[i] == rank]
        counts = [sum(1 for o in owner if o == r) for r in range(world_size)]
        target = max(counts)
        rng = random.Random(1234 + rank)
        while len(mine) < target and mine:
            mine.append(rng.choice(mine))
        self._local_indices = mine
        self.num = len(mine)

    def _global_index(self, idx: int) -> int:
        if self.world_size <= 1:
            return idx
        return self._local_indices[idx]

    def _meta(self, idx: int):
        return super()._meta(self._global_index(idx))

    def _load_image(self, idx: int, meta):
        return super()._load_image(self._global_index(idx), meta)


@DATASETS.register(name="clip_ranked")
def build_clip_ranked(**kwargs) -> ClipDatasetRanked:
    return ClipDatasetRanked(**kwargs)
