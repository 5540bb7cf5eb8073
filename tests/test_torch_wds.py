"""The port's fast input path against the JAX package, on the CPU:
webdataset shards (data/wds.py, tools/make_wds.py), the native JPEG
decoder (data/native.py over csrc/fastload.cc) and the ImageNet loader
builders (data/imagenet.py).

Shards packed by the port's ``make_wds`` are the JAX tool's byte for byte
and read the same through both packages' ``WdsClipDataset`` (keys,
captions, labels, decoded images bit for bit, with PIL and with the
native reader); each package reads the other's index sidecar; the native
primitives equal the JAX package's bit for bit on seeded JPEGs. Needs a
C++ compiler and libjpeg's headers (both are here).
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from declip_tpu.data import native as jax_native
from declip_tpu.data import wds as jax_wds
from declip_tpu.tools import make_wds as jax_make_wds

from declip_tpu_torch.data import native, wds
from declip_tpu_torch.tools import make_wds


def _jpeg(rng, w, h, mode="RGB"):
    buf = io.BytesIO()
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """14 images (a grayscale JPEG and a PNG among them) with captions,
    some with label/label_name/tag, a metafile line for a missing file, and
    the shards of both packages' make_wds (5 samples a shard)."""
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(14):
        w, h = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        if i == 5:
            name = f"{i}.png"
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                root / name)
        else:
            name = f"{i}.jpeg" if i == 2 else f"{i}.jpg"
            (root / name).write_bytes(
                _jpeg(rng, w, h, "L" if i == 9 else "RGB"))
        entry = {"filename": name, "caption": f"a photo of thing {i}"}
        if i % 3 == 0:
            entry.update(label=i % 4, label_name=f"class {i % 4}", tag="t")
        lines.append(json.dumps(entry))
    lines.insert(4, json.dumps({"filename": "missing.jpg", "caption": "x"}))
    meta = root / "meta.jsonl"
    meta.write_text("\n".join(lines) + "\n")
    for pkg in ("port", "jax"):
        (root / pkg).mkdir()
    return root, meta


@pytest.fixture(scope="module")
def shards(corpus):
    root, meta = corpus
    port = make_wds.pack(str(meta), str(root), str(root / "port" /
                                                    "s-%05d.tar"), 5)
    jax = jax_make_wds.pack(str(meta), str(root), str(root / "jax" /
                                                      "s-%05d.tar"), 5)
    assert port == jax == (14, 3, 1)
    return root, f"{root}/port/s-{{00000..00002}}.tar"


def test_make_wds_writes_the_jax_tools_shards(shards, capsys):
    root, _ = shards
    for i in range(3):
        assert (root / "port" / f"s-{i:05d}.tar").read_bytes() == \
            (root / "jax" / f"s-{i:05d}.tar").read_bytes()
    out = root / "cli"
    out.mkdir()
    make_wds.main(["--meta", str(root / "meta.jsonl"), "--root", str(root),
                   "--out", str(out / "s-%05d.tar"),
                   "--samples-per-shard", "8"])
    assert json.loads(capsys.readouterr().out) == \
        {"samples": 14, "shards": 2, "skipped": 1}
    with pytest.raises(NotImplementedError, match="item 1.7a.5"):
        make_wds.pack(str(root / "meta.jsonl"), str(root),
                      "gs://bucket/s-%05d.tar", 8)


@pytest.mark.parametrize("reader", ["pil", "native"])
def test_shards_read_the_same_in_both_packages(shards, reader):
    from declip_tpu.data.transforms import build_common_augmentation as jt
    from declip_tpu_torch.data.dataloader import build_clip_dataset

    _, spec = shards
    port = build_clip_dataset({"type": "clip_wds", "tar_files": spec,
                               "image_reader": {"type": reader,
                                                "min_side": 48},
                               "transforms": {"type": "ONECROP"}})
    jax = jax_wds.WdsClipDataset(tar_files=spec, transform=jt("ONECROP"),
                                 image_reader_type=reader,
                                 native_min_side=48)
    assert isinstance(port, wds.WdsClipDataset)
    assert len(port) == len(jax) == 14
    labels = 0
    for i in range(len(port)):
        assert port._key(i) == jax._key(i)
        assert port._meta(i) == jax._meta(i)
        labels += "label" in port._meta(i)
        got = np.asarray(port._load_image(i, port._meta(i)))
        want = np.asarray(jax._load_image(i, jax._meta(i)))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(i))
        a, b = port[i], jax[i]
        assert {k: v for k, v in a.items() if k != "image"} == \
            {k: v for k, v in b.items() if k != "image"}
        np.testing.assert_array_equal(a["image"], b["image"])
    assert labels == 5


def test_index_sidecars_are_shared(shards):
    """A sidecar written by one package is read by the other, as is."""
    root, _ = shards
    tar = str(root / "port" / "s-00001.tar")
    side = tar + ".idx.json"
    for writer, reader in ((jax_wds, wds), (wds, jax_wds)):
        if os.path.exists(side):
            os.remove(side)
        want = writer.build_tar_index(tar)
        stamp = os.stat(side).st_mtime_ns
        with open(side) as f:
            body = f.read()
        assert reader.build_tar_index(tar) == want
        assert os.stat(side).st_mtime_ns == stamp
        with open(side) as f:
            assert f.read() == body


def test_expand_shards_matches_jax(shards):
    root, spec = shards
    d = root / "port"
    for s in (spec, f"{d}/s-*.tar", f"{d}/s-00002.tar",
              [f"{d}/s-00000.tar", f"{d}/s-{{1..2}}.tar"],
              f"{d}/x-{{08..11}}.tar"):
        assert wds.expand_shards(s) == jax_wds.expand_shards(s), s
    assert len(wds.expand_shards(spec)) == 3
    with pytest.raises(NotImplementedError, match="item 1.7a.5"):
        wds.expand_shards("gs://bucket/s-{0000..0003}.tar")
    with pytest.raises(NotImplementedError, match="item 1.7a.5"):
        wds.WdsClipDataset(tar_files=["gs://bucket/a.tar"])


def test_native_primitives_match_jax(corpus):
    """decode_jpeg (full size and DCT-prescaled), jpeg_dims,
    decode_crop_resize and scan_offsets bit for bit; a PNG is not a JPEG."""
    root, meta = corpus
    assert native.available() and jax_native.available()
    jpegs = sorted(p for p in os.listdir(root) if p.endswith((".jpg",
                                                              ".jpeg")))
    assert len(jpegs) == 13
    for name in jpegs:
        data = (root / name).read_bytes()
        assert native.jpeg_dims(data) == jax_native.jpeg_dims(data)
        for min_side in (0, 20, 48):
            got = native.decode_jpeg(data, min_side)
            assert got.dtype == np.uint8 and got.shape[2] == 3
            np.testing.assert_array_equal(
                got, jax_native.decode_jpeg(data, min_side))
        w, h = native.jpeg_dims(data)
        box = (w * 0.1, h * 0.2, w * 0.6, h * 0.5)
        np.testing.assert_array_equal(
            native.decode_crop_resize(data, box, (24, 16)),
            jax_native.decode_crop_resize(data, box, (24, 16)))
    np.testing.assert_array_equal(native.scan_offsets(str(meta)),
                                  jax_native.scan_offsets(str(meta)))
    png = (root / "5.png").read_bytes()
    for fn in (native.jpeg_dims, native.decode_jpeg):
        with pytest.raises(ValueError):
            fn(png)


def test_native_reader_sends_a_png_to_pil(corpus):
    from declip_tpu_torch.data.dataset import ClipDataset, pil_loader

    root, _ = corpus
    meta = root / "png.jsonl"
    meta.write_text(json.dumps({"filename": "5.png", "caption": "c"}) + "\n"
                    + json.dumps({"filename": "6.jpg", "caption": "c"}))
    ds = ClipDataset(str(root), str(meta), image_reader_type="native",
                     native_min_side=0)
    png = ds._load_image(0, ds._meta(0))
    np.testing.assert_array_equal(
        np.asarray(png), np.asarray(pil_loader((root / "5.png").read_bytes())))
    jpg = ds._load_image(1, ds._meta(1))
    np.testing.assert_array_equal(
        np.asarray(jpg), native.decode_jpeg((root / "6.jpg").read_bytes()))


def test_native_reader_counts_a_jpeg_that_libjpeg_rejects(corpus, tmp_path):
    """A CMYK JPEG: libjpeg refuses the RGB conversion, so the native
    reader decodes it with PIL (the JAX package's image) and counts it; a
    PNG or a JPEG that native decodes is not counted."""
    from declip_tpu_torch.data.dataset import ClipDataset, pil_loader

    root, _ = corpus
    buf = io.BytesIO()
    Image.new("CMYK", (24, 16), (10, 200, 30, 5)).save(buf, "JPEG")
    cmyk = buf.getvalue()
    assert cmyk[:2] == b"\xff\xd8"
    with pytest.raises(ValueError):
        native.decode_jpeg(cmyk)
    with pytest.raises(ValueError):
        jax_native.decode_jpeg(cmyk)
    (tmp_path / "cmyk.jpg").write_bytes(cmyk)
    meta = tmp_path / "cmyk.jsonl"
    meta.write_text("\n".join(json.dumps({"filename": f, "caption": "c"})
                              for f in ("cmyk.jpg", "cmyk.jpg")) + "\n")
    ds = ClipDataset(str(tmp_path), str(meta), image_reader_type="native")
    other = ClipDataset(str(root), str(root / "meta.jsonl"),
                        image_reader_type="native")
    for i in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(ds._load_image(i, ds._meta(i))),
            np.asarray(pil_loader(cmyk)))
    assert ds.native_fallbacks == 2
    assert [other._meta(i)["filename"] for i in (5, 6)] == ["4.jpg", "5.png"]
    for i in (5, 6):
        other._load_image(i, other._meta(i))
    assert other.native_fallbacks == 0 == ClipDataset.native_fallbacks


def test_native_without_a_compiler_raises_when_the_dataset_is_built(
        corpus, tmp_path, monkeypatch):
    from declip_tpu_torch.data.dataset import ClipDataset

    root, meta = corpus
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        ClipDataset(str(root), str(meta), image_reader_type="native")
    assert not native.available()
    ClipDataset(str(root), str(meta))  # PIL needs no compiler


def test_imagenet_loaders_match_jax(corpus, tmp_path):
    from declip_tpu.data import imagenet as jax_imagenet

    from declip_tpu_torch.data import imagenet

    root, _ = corpus
    listing = tmp_path / "val.txt"
    listing.write_text("".join(f"{i}.jpg {i % 3}\n" for i in (0, 1, 3, 4,
                                                               6, 7)))
    cfg = {"root_dir": str(root), "meta_file": str(listing),
           "batch_size": 2, "num_workers": 1,
           "transforms": {"type": "ONECROP"}, "max_iter": 3}
    port = imagenet.build_imagenet_test_dataloader(cfg)
    jax = jax_imagenet.build_imagenet_test_dataloader(cfg)
    assert len(port) == len(jax) == 6
    for i in range(6):
        a, b = port[i], jax[i]
        assert {k: v for k, v in a.items() if k != "image"} == \
            {k: v for k, v in b.items() if k != "image"}
        np.testing.assert_array_equal(a["image"], b["image"])
    for sampler in ("distributed_iteration", "distributed_epoch"):
        c = dict(cfg, sampler={"type": sampler})
        got = list(imagenet.build_imagenet_train_dataloader(c))
        want = list(jax_imagenet.build_imagenet_train_dataloader(c))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            assert g["images"].shape == (2, 224, 224, 3)
            np.testing.assert_array_equal(g["images"], w["images"])
