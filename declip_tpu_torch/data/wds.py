"""WebDataset-style tar-shard dataset with random access (the port's copy of
declip_tpu/data/wds.py; local shards).

Public CLIP-scale corpora (LAION, DataComp) ship as webdataset tar shards
(``shard-{0000..9999}.tar`` holding ``<key>.jpg`` + ``<key>.txt`` pairs);
the reference reads loose files keyed by a JSONL metafile. This module
serves the shards through the ClipDataset item interface.

Design, as in JAX: MAP-STYLE, with a per-shard member index (name -> byte
offset and size, built once with the stdlib tarfile parser and cached as a
JSON sidecar, ``<tar>.idx.json``, in the JAX package's format, so a shard
set indexed by one package is read by the other). Random access keeps the
samplers' exact resume, the batch-index-keyed MLM/EDA replay and the
resample-on-error contract. Reads are ranged (seek and read), so shards are
never unpacked.

Config::

    data: {train: {type: clip_wds, tar_files: "/data/shard-{0000..0127}.tar",
                   batch_size: 128, ...}}

``tar_files`` accepts a single path, a brace range (webdataset convention),
a glob, or a list. Captions come from the sample's ``.txt`` member or a
``.json`` member's ``caption`` key; labels from ``.cls`` (int) or the
json's ``label``/``label_name``.

Not in the port yet: shards on object stores (``gs://``; ROADMAP.md item
1.7a.5, with the other stores), which raise.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import os.path as osp
import random
import re
import tarfile
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

from declip_tpu_torch.data.dataset import ClipDataset, check_image_reader
from declip_tpu_torch.utils.registry import DATASETS

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "ppm", "bmp", "pgm", "tif",
              "tiff")

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def _refuse_remote(path: str) -> None:
    if "://" in path:
        raise NotImplementedError(
            f"{path}: shards on object stores are not ported yet (ROADMAP.md "
            f"item 1.7a.5); the port reads local shards")


def expand_shards(spec: Union[str, Sequence[str]]) -> List[str]:
    """Expand a shard spec into an ordered list of tar paths: the
    webdataset brace convention (``s-{0000..0127}.tar``, zero-padding taken
    from the left endpoint), glob patterns, lists, and single paths."""
    if isinstance(spec, (list, tuple)):
        out: List[str] = []
        for s in spec:
            out.extend(expand_shards(s))
        return out
    spec = str(spec)
    _refuse_remote(spec)
    m = _BRACE.search(spec)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        expanded = [
            spec[: m.start()] + str(i).zfill(width) + spec[m.end():]
            for i in range(int(lo), int(hi) + 1)
        ]
        return [p for e in expanded for p in expand_shards(e)]
    if any(c in spec for c in "*?["):
        return sorted(_glob.glob(spec))
    return [spec]


def _index_cache_path(tar_path: str, size: int) -> str:
    """Sidecar location for a shard's member index: next to the tar, or in
    the JAX package's cache directory on a read-only mount (the same name,
    so the packages share it)."""
    side = tar_path + ".idx.json"
    if os.access(osp.dirname(osp.abspath(tar_path)) or ".", os.W_OK):
        return side
    import hashlib

    cache_dir = os.environ.get(
        "DECLIP_META_CACHE", osp.expanduser("~/.cache/declip_meta"))
    os.makedirs(cache_dir, exist_ok=True)
    h = hashlib.sha1(f"{tar_path}:{size}".encode()).hexdigest()
    return osp.join(cache_dir, h + ".taridx.json")


def _shard_stat(tar_path: str) -> Tuple[int, str]:
    """(size, mtime): both validate the index sidecar. Size alone is not
    enough: tarfile pads archives to a 10240-byte record, so appending a
    small member can leave the file size unchanged."""
    st = os.stat(tar_path)
    return st.st_size, str(st.st_mtime_ns)


def build_tar_index(tar_path: str) -> List[Tuple[str, int, int]]:
    """``[(member_name, data_offset, size)]`` for every regular file in the
    shard, in archive order, cached as a JSON sidecar validated by the
    shard's size and mtime."""
    _refuse_remote(tar_path)
    size, mtime = _shard_stat(tar_path)
    cache = _index_cache_path(tar_path, size)
    if osp.exists(cache):
        try:
            with open(cache) as f:
                d = json.load(f)
            if (d.get("size") == size and d.get("mtime") == mtime
                    and d.get("v") == 1):
                return [tuple(m) for m in d["members"]]
        except (OSError, ValueError, KeyError, TypeError):
            pass  # a corrupt sidecar: rebuilt below
    members: List[Tuple[str, int, int]] = []
    with open(tar_path, "rb") as f:
        # ignore_zeros tolerates the zero-padded blocks some shard writers
        # emit between appends
        with tarfile.open(fileobj=f, mode="r:", ignore_zeros=True) as tf:
            for ti in tf:
                if ti.isreg():
                    members.append((ti.name, ti.offset_data, ti.size))
    tmp = f"{cache}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump({"v": 1, "size": size, "mtime": mtime,
                       "members": members}, f)
        os.replace(tmp, cache)  # atomic: concurrent workers race safely
    except OSError:
        pass  # an unwritable cache directory: the index is still returned
    return members


def _sample_key(name: str) -> Tuple[str, str]:
    """webdataset split: key = path up to the FIRST dot of the basename,
    extension = the rest (so ``a/b.seg.png`` -> (``a/b``, ``seg.png``))."""
    d, base = osp.split(name)
    stem, _, ext = base.partition(".")
    return (osp.join(d, stem) if d else stem), ext.lower()


class WdsClipDataset(ClipDataset):
    """Tar-shard image-text dataset served through the ClipDataset item
    interface (resample-on-error, prompt ensembles, native decode)."""

    def __init__(
        self,
        tar_files: Union[str, Sequence[str]],
        transform=None,
        caption_key: str = "caption",
        image_exts: Sequence[str] = IMAGE_EXTS,
        label_texts_ensemble: str = "none",
        evaluator=None,
        image_reader_type: str = "pil",
        native_min_side: int = 512,
        seed: int = 0,
        **_,
    ):
        check_image_reader(image_reader_type)
        self.read_from = "wds"
        self.fseek = False
        self.transform = transform
        self.label_texts_ensemble = label_texts_ensemble
        self.evaluator = evaluator
        self.image_reader_type = image_reader_type
        self.native_min_side = native_min_side
        self._fake_bytes = None
        self._rng = random.Random(seed)
        self.roots: List[str] = []
        self.metas: List[Dict] = []
        self._offsets: List[Tuple[str, int]] = []
        self.caption_key = caption_key

        self.shards = expand_shards(tar_files)
        if not self.shards:
            raise ValueError(f"no shards match {tar_files!r}")
        image_exts = tuple(e.lower() for e in image_exts)
        self._image_exts = set(image_exts)
        # the sample table as numpy columns, not Python objects (every host
        # holds the whole table): (img_off, img_size, txt_off, txt_size,
        # js_off, js_size, cls_off, cls_size), -1 = member absent; rows in
        # (shard, archive offset) order
        shard_col: List[np.ndarray] = []
        member_col: List[np.ndarray] = []
        self._row0: List[int] = []  # first global row of each shard
        n = 0
        for si, shard in enumerate(self.shards):
            groups: Dict[str, Dict[str, Tuple[int, int]]] = {}
            order: List[str] = []
            for name, off, size in build_tar_index(shard):
                key, ext = _sample_key(name)
                g = groups.setdefault(key, {})
                if not g:
                    order.append(key)
                g[ext] = (off, size)
            rows = []
            for key in order:
                g = groups[key]
                img = next((g[e] for e in image_exts if e in g), None)
                if img is None:
                    continue  # a key without an image (metadata only)
                rows.append(img + (g.get("txt") or (-1, -1))
                            + (g.get("json") or (-1, -1))
                            + (g.get("cls") or (-1, -1)))
            self._row0.append(n)
            n += len(rows)
            shard_col.append(np.full(len(rows), si, np.int32))
            member_col.append(np.asarray(rows, np.int64).reshape(-1, 8))
        self._shard_of = np.concatenate(shard_col)
        self._members = np.concatenate(member_col)
        self._keys_cache: Dict[int, List[str]] = {}
        self.num = int(self._members.shape[0])

    # ---- ranged member reads ------------------------------------------
    def _read_member(self, shard_idx: int, off: int, size: int) -> bytes:
        with open(self.shards[shard_idx], "rb") as f:
            f.seek(off)
            return f.read(size)

    def _key(self, idx: int) -> str:
        """Sample key for display (eval dumps), rebuilt per shard on first
        touch from the cached tar index."""
        si = int(self._shard_of[idx])
        keys = self._keys_cache.get(si)
        if keys is None:
            exts: Dict[str, set] = {}
            order: List[str] = []
            for name, _off, _size in build_tar_index(self.shards[si]):
                key, ext = _sample_key(name)
                s = exts.setdefault(key, set())
                if not s:
                    order.append(key)
                s.add(ext)
            # the same per-key image filter as __init__, so rows line up
            keys = [k for k in order if exts[k] & self._image_exts]
            if len(self._keys_cache) > 8:  # bound resident key lists
                self._keys_cache.clear()
            self._keys_cache[si] = keys
        return keys[idx - self._row0[si]]

    # ---- ClipDataset item protocol overrides ---------------------------
    def _meta(self, idx: int) -> Dict:
        si = int(self._shard_of[idx])
        m = self._members[idx]
        meta: Dict[str, Any] = {
            "filename": f"{self.shards[si]}/{self._key(idx)}",
            "caption": "",
            "tag": "",
        }
        if m[4] >= 0:  # .json
            d = json.loads(self._read_member(si, int(m[4]), int(m[5])))
            meta["caption"] = d.get(self.caption_key, "") or ""
            if "label" in d:
                meta["label"] = int(d["label"])
            if "label_name" in d:
                meta["label_name"] = d["label_name"]
            if "tag" in d:
                meta["tag"] = d["tag"]
        if m[2] >= 0:  # .txt is THE caption when present (wds convention)
            meta["caption"] = self._read_member(
                si, int(m[2]), int(m[3])).decode("utf-8", "replace").strip()
        if m[6] >= 0:  # .cls
            meta["label"] = int(
                self._read_member(si, int(m[6]), int(m[7])).decode().strip())
        if not meta["caption"] and "label" in meta:
            # an eval-style shard (<key>.jpg + <key>.cls only): ClipDataset
            # resamples empty captions, so labeled caption-less samples get
            # ImageNetDataset's placeholder; zero-shot eval reads the label
            meta["caption"] = "-"
        return meta

    def _load_image(self, idx: int, meta: Dict):
        si = int(self._shard_of[idx])
        m = self._members[idx]
        return self._decode(self._read_member(si, int(m[0]), int(m[1])))


@DATASETS.register(name="clip_wds")
def build_wds_dataset(**kwargs) -> WdsClipDataset:
    return WdsClipDataset(**kwargs)
