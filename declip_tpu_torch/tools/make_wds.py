"""Pack a reference-layout dataset into webdataset tar shards (the port's
copy of declip_tpu/tools/make_wds.py; local paths).

The reference keeps training data as loose image files addressed by a JSONL
metafile (prototype/data/datasets/clip_dataset.py:66-91). This tool streams
the metafile's entries into ``shard-%05d.tar`` archives of ``<key>.jpg`` +
``<key>.txt`` (+ ``<key>.json`` when the entry carries label, label_name or
tag), which ``type: clip_wds`` (data/wds.py) reads. The shards are the JAX
package's, byte for byte. Image bytes are copied verbatim (no decode or
re-encode); unreadable files are skipped and counted. Usage::

    python -m declip_tpu_torch.tools.make_wds \\
        --meta train.jsonl --root /data/images \\
        --out /data/wds/shard-%05d.tar --samples-per-shard 10000

Object-store paths (``gs://``) are not ported yet (ROADMAP.md item 1.7a.5)
and raise.
"""

from __future__ import annotations

import argparse
import io
import json
import os.path as osp
import tarfile
from typing import Iterator, Tuple


def _refuse_remote(path: str) -> None:
    if "://" in path:
        raise NotImplementedError(
            f"{path}: object stores are not ported yet (ROADMAP.md item "
            f"1.7a.5); make_wds reads and writes local paths")


def _iter_meta(meta_path: str) -> Iterator[dict]:
    with open(meta_path) as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    ti = tarfile.TarInfo(name)
    ti.size = len(data)
    tf.addfile(ti, io.BytesIO(data))


def pack(meta: str, root: str, out_pattern: str, samples_per_shard: int,
         caption_key: str = "caption") -> Tuple[int, int, int]:
    """-> (n_samples, n_shards, n_skipped). ``out_pattern`` must contain a
    printf-style integer field (e.g. ``shard-%05d.tar``)."""
    _refuse_remote(meta)
    _refuse_remote(out_pattern)
    n = shard_i = skipped = 0
    tf = None
    try:
        for entry in _iter_meta(meta):
            caption = entry.get(caption_key, "")
            if isinstance(caption, list):
                caption = caption[0] if caption else ""
            fname = entry.get("filename", "")
            try:
                with open(osp.join(root, fname), "rb") as f:
                    img = f.read()
            except OSError:
                skipped += 1
                continue
            if n % samples_per_shard == 0:
                if tf is not None:
                    tf.close()
                tf = tarfile.open(out_pattern % shard_i, mode="w")
                shard_i += 1
            key = f"{n:09d}"
            ext = osp.splitext(fname)[1].lstrip(".").lower() or "jpg"
            if ext == "jpeg":
                ext = "jpg"
            _add(tf, f"{key}.{ext}", img)
            _add(tf, f"{key}.txt", str(caption).encode())
            side = {k: entry[k] for k in ("label", "label_name", "tag")
                    if k in entry}
            if side:
                _add(tf, f"{key}.json", json.dumps(side).encode())
            n += 1
    finally:
        if tf is not None:
            tf.close()
    return n, shard_i, skipped


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Pack a JSONL metafile and its images into webdataset "
                    "tar shards.")
    ap.add_argument("--meta", required=True, help="JSONL metafile")
    ap.add_argument("--root", default="", help="image root dir")
    ap.add_argument("--out", required=True,
                    help="output pattern, e.g. /data/wds/shard-%%05d.tar")
    ap.add_argument("--samples-per-shard", type=int, default=10000)
    ap.add_argument("--caption-key", default="caption")
    args = ap.parse_args(argv)
    n, shards, skipped = pack(args.meta, args.root, args.out,
                              args.samples_per_shard, args.caption_key)
    print(json.dumps({"samples": n, "shards": shards, "skipped": skipped}))


if __name__ == "__main__":
    main()
