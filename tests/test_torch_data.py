"""The port's host data path against the JAX package's: samplers, datasets,
transforms, EDA, the loader, evaluators, prompt ensembles, config
overrides and meters. Both sides are numpy, PIL and Python, so they must
agree exactly on the same seeds and inputs: same indices, same items, the
same image arrays bit for bit, the same token rows, the same metrics.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import io
import json
import random

import numpy as np
import pytest
from PIL import Image

SAMPLER_KW = dict(dataset_size=37, world_size=3, rank=1)


@pytest.mark.parametrize("last_iter", [-1, 4], ids=["fresh", "resumed"])
@pytest.mark.parametrize("stype,kwargs", [
    ("distributed", {}),
    ("distributed_iteration", {"total_iter": 11, "batch_size": 4,
                               "seed": 3}),
    ("distributed_iteration", {"total_iter": 11, "batch_size": 2,
                               "world_size": 6, "rank": 4,
                               "orig_world_size": 3,
                               "orig_batch_size": 4}),
    ("distributed_epoch", {"total_iter": 11, "batch_size": 4, "seed": 3}),
    ("ranked_iteration", {"total_iter": 11, "batch_size": 4, "seed": 3}),
], ids=["epoch_plain", "iteration", "iteration_elastic", "epoch",
        "ranked"])
def test_samplers_match_jax(stype, kwargs, last_iter):
    import declip_tpu.data.sampler  # noqa: F401  (fills the registry)
    import declip_tpu_torch.data.sampler  # noqa: F401
    from declip_tpu.utils.registry import SAMPLERS as JAX_SAMPLERS
    from declip_tpu_torch.utils.registry import SAMPLERS

    kw = {**SAMPLER_KW, **kwargs}
    if stype != "distributed":
        kw["last_iter"] = last_iter
    got, want = SAMPLERS.get(stype)(**kw), JAX_SAMPLERS.get(stype)(**kw)
    assert list(got) == list(want) and len(got) == len(want)
    if stype == "distributed":
        got.set_epoch(2)
        want.set_epoch(2)
        assert list(got) == list(want)


def test_compute_total_iter_matches_jax():
    from declip_tpu.data.sampler import compute_total_iter as jax_total
    from declip_tpu_torch.data.sampler import compute_total_iter

    for cfg in ({"max_iter": 17}, {"max_epoch": 3, "batch_size": 8},
                {"max_epoch": 0.5, "batch_size": 5}):
        assert compute_total_iter(cfg, 1000, 4) == jax_total(cfg, 1000, 4)


def _jpeg(rng, w, h):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A JSONL corpus of 12 small JPEGs; item 3 has an empty caption and
    item 7 a Chinese one (both rejected and resampled)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(12):
        w, h = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        (root / f"{i}.jpg").write_bytes(_jpeg(rng, w, h))
        caption = {3: "", 7: "一只猫"}.get(i, f"a photo of a dog number {i}")
        lines.append(json.dumps({"filename": f"{i}.jpg", "caption": caption,
                                 "label": i % 4,
                                 "label_name": f"thing {i % 4}"}))
    meta = root / "meta.jsonl"
    meta.write_text("\n".join(lines) + "\n\n")
    # the good items only: which worker meets a bad item first decides
    # the resample, so the loader tests leave them out
    (root / "good.jsonl").write_text("".join(
        line + "\n" for i, line in enumerate(lines) if i not in (3, 7)))
    return root, meta


def _datasets(**kw):
    from declip_tpu.data.dataset import ClipDataset as JaxClipDataset
    from declip_tpu.data.transforms import build_common_augmentation as jt
    from declip_tpu_torch.data.dataset import ClipDataset
    from declip_tpu_torch.data.transforms import build_common_augmentation

    port = ClipDataset(transform=build_common_augmentation("ONECROP"), **kw)
    jax = JaxClipDataset(transform=jt("ONECROP"), **kw)
    return port, jax


def _same_item(a, b):
    assert {k: v for k, v in a.items() if k != "image"} == \
        {k: v for k, v in b.items() if k != "image"}
    np.testing.assert_array_equal(a["image"], b["image"])


@pytest.mark.parametrize("fseek", [False, True], ids=["in_ram", "fseek"])
def test_fs_dataset_matches_jax(corpus, fseek):
    root, meta = corpus
    port, jax = _datasets(root_dir=str(root), meta_file=str(meta),
                          fseek=fseek, seed=5)
    assert len(port) == len(jax) == 12
    for i in range(12):
        _same_item(port[i], jax[i])
    # the bad captions resample to the same seeded index on both sides
    assert port[3]["image_id"] == jax[3]["image_id"] != 3
    assert port[7]["caption"] == jax[7]["caption"] != "一只猫"


def test_synthetic_dataset_matches_jax():
    port, jax = _datasets(root_dir="", meta_file="20", read_from="synthetic",
                          label_texts_ensemble="prompt6")
    for i in (0, 7, 19):
        _same_item(port[i], jax[i])
    assert port.get_label_texts()[0] == jax.get_label_texts()[0]
    np.testing.assert_array_equal(port.get_label_texts()[1],
                                  jax.get_label_texts()[1])


def test_imagenet_and_ranked_datasets_match_jax(corpus, tmp_path):
    from declip_tpu.data.dataset import ClipDatasetRanked as JaxRanked
    from declip_tpu.data.dataset import ImageNetDataset as JaxImageNet
    from declip_tpu_torch.data.dataset import ClipDatasetRanked, ImageNetDataset

    root, meta = corpus
    listing = tmp_path / "val.txt"
    listing.write_text("".join(f"{i}.jpg {i % 3}\n" for i in range(6)))
    names = ["ant", "bee", "cat"]
    for fseek in (False, True):
        kw = dict(root_dir=str(root), meta_file=str(listing),
                  class_names=names, fseek=fseek)
        port, jax = ImageNetDataset(**kw), JaxImageNet(**kw)
        for i in range(6):
            _same_item(port[i], jax[i])
    kw = dict(root_dir=str(root), meta_file=str(meta), world_size=3, rank=2)
    port, jax = ClipDatasetRanked(**kw), JaxRanked(**kw)
    assert len(port) == len(jax)
    for i in range(len(port)):
        _same_item(port[i], jax[i])


@pytest.mark.parametrize("ens", ["none", "cc", "simple", "prompt6",
                                 "prompt8", "prompt80", "file"])
def test_prompt_ensembles_match_jax(corpus, tmp_path, ens):
    root, meta = corpus
    if ens == "file":
        path = tmp_path / "prompts.txt"
        path.write_text("a {0} here.\n\nthe {0}!\n")
        ens = f"file:{path}"
    port, jax = _datasets(root_dir=str(root), meta_file=str(meta),
                          label_texts_ensemble=ens)
    texts, matrix = port.get_label_texts()
    want_texts, want_matrix = jax.get_label_texts()
    assert texts == want_texts and len(texts) % 4 == 0
    np.testing.assert_array_equal(matrix, want_matrix)


def test_unported_stores_raise(corpus):
    from declip_tpu_torch.data.dataset import ClipDataset

    root, meta = corpus
    for kw in ({"read_from": "gcs"}, {"read_from": "ceph"},
               {"meta_file": "gs://bucket/meta.jsonl"},
               {"server_cfg": {"ip": "127.0.0.1", "port": 1}}):
        with pytest.raises(NotImplementedError, match="item 1.7a"):
            ClipDataset(**{"root_dir": str(root), "meta_file": str(meta),
                           **kw})


@pytest.fixture(scope="module")
def photo():
    rng = np.random.default_rng(11)
    return Image.fromarray(rng.integers(0, 256, (180, 260, 3), np.uint8))


@pytest.mark.parametrize("aug", [
    "STANDARD", "STANDARD256", "LINEAR", "STANDARD_SLIP", "STANDARD_CLIP",
    "MOCOV1", "MOCOV2", "SIMSIAM", "MOCOV2_256", "SLIP", "ONECROP256"])
def test_transforms_match_jax(photo, aug):
    """The same preset under the same ``random.Random`` seed: the same
    draws, so the same arrays bit for bit (several images, so that every
    random branch is taken)."""
    from declip_tpu.data.transforms import build_common_augmentation as jt
    from declip_tpu_torch.data.transforms import build_common_augmentation

    port = build_common_augmentation(aug, random.Random(7))
    jax = jt(aug, random.Random(7))
    for _ in range(3):
        got, want = port(photo), jax(photo)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    views = {"MOCOV1": 2, "MOCOV2": 2, "SIMSIAM": 2, "MOCOV2_256": 2,
             "SLIP": 3}.get(aug, 1)
    assert got.shape[-1] == 3 * views


def test_transform_table_matches_jax(photo):
    """A list-style pipeline over every TRANSFORM_TABLE entry."""
    from declip_tpu.data import transforms as jt
    from declip_tpu_torch.data import transforms as pt

    assert set(pt.TRANSFORM_TABLE) == set(jt.TRANSFORM_TABLE)
    cfgs = [{"type": "resize", "kwargs": {"size": 120}},
            {"type": "random_rotation", "kwargs": {"degrees": 20}},
            {"type": "random_orientation_rotation"},
            {"type": "ramdom_vertical_flip", "kwargs": {"p": 0.5}},
            {"type": "random_horizontal_flip"},
            {"type": "color_jitter", "kwargs": {"brightness": 0.3,
                                                "hue": 0.1}},
            {"type": "gaussian_blur"},
            {"type": "adjust_gamma", "kwargs": {"gamma": 0.8}},
            {"type": "to_grayscale"},
            {"type": "random_resized_crop", "kwargs": {"size": 64}},
            {"type": "center_crop", "kwargs": {"size": 48}},
            {"type": "to_tensor"}, {"type": "normalize"},
            {"type": "cutout", "kwargs": {"prob": 1.0, "length": 8}}]
    for seed in (1, 2):
        random.seed(seed)
        got = pt.build_transformer(cfgs)(photo)
        random.seed(seed)
        want = jt.build_transformer(cfgs)(photo)
        np.testing.assert_array_equal(got, want)


def test_eda_matches_jax():
    from declip_tpu.tokenizer.eda import EDA as JaxEDA
    from declip_tpu.tokenizer.eda import default_synonym_table as jax_table
    from declip_tpu_torch.tokenizer.eda import EDA, default_synonym_table

    assert default_synonym_table() == jax_table()
    words = sorted(default_synonym_table())
    rng = np.random.default_rng(2)
    captions = [" ".join(rng.choice(words, size=int(rng.integers(5, 21))))
                for _ in range(40)] + ["", "one", "a cat, on a mat!"]
    for seed in (0, 1_000_003 * 4 + 9):
        got = EDA(seed=seed).augment_batch(captions)
        assert got == JaxEDA(seed=seed).augment_batch(captions)
    assert sum(g != c for g, c in zip(got, captions)) > 20


def _loader_cfg(root, meta, **extra):
    return {"root_dir": str(root), "meta_file": str(meta), "batch_size": 3,
            "num_workers": 2, "transforms": {"type": "ONECROP"},
            "sampler": {"type": "distributed_iteration"}, "seed": 4,
            "eda": True, "text_mask_type": "MLM", "max_iter": 6,
            "fseek": True, **extra}


@pytest.mark.parametrize("worker_type", ["thread", "process"])
def test_loader_batches_match_jax(corpus, worker_type):
    """ONECROP batches with EDA captions and MLM masks from the port's
    thread and process loaders against the JAX thread loader, from the
    start and after a resume at step 3 (start_batch_idx continues the EDA
    and MLM keys)."""
    from declip_tpu.data.dataloader import build_clip_dataloader as jax_build
    from declip_tpu_torch.data.dataloader import build_clip_dataloader

    root, _ = corpus
    meta = root / "good.jsonl"
    keys = ("images", "tokens", "tokens_aug", "mlm_tokens", "mlm_labels",
            "labels")
    for last_iter in (-1, 2):
        got = list(build_clip_dataloader(
            _loader_cfg(root, meta, worker_type=worker_type),
            last_iter=last_iter))
        want = list(jax_build(_loader_cfg(root, meta), last_iter=last_iter))
        assert len(got) == len(want) == 6 - (last_iter + 1)
        assert len(got[0]["images"]) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w) == set(keys)
            for k in keys:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert any((b["mlm_labels"] != -100).any() for b in got)
        assert any((b["tokens_aug"] != b["tokens"]).any() for b in got)


def test_wds_loader_raises():
    from declip_tpu_torch.data.dataloader import build_clip_dataset

    with pytest.raises(NotImplementedError, match="item 1.7a.5"):
        build_clip_dataset({"type": "clip_wds",
                            "tar_files": "gs://bucket/a-{0..3}.tar"})


def test_evaluators_match_jax(tmp_path):
    from declip_tpu.data import evaluator as je
    from declip_tpu_torch.data import evaluator as pe

    rng = np.random.default_rng(5)
    scores = rng.random((50, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 50)
    for name in ("ImageNetEvaluator", "CustomEvaluator"):
        assert getattr(pe, name)().eval_arrays(scores, labels) == \
            getattr(je, name)().eval_arrays(scores, labels)
    heads = [scores, rng.random((50, 7))]
    two = np.stack([labels, rng.integers(0, 7, 50)], 1)
    assert pe.MultiClsEvaluator().eval_arrays(heads, two) == \
        je.MultiClsEvaluator().eval_arrays(heads, two)
    img, txt = rng.standard_normal((40, 8)), rng.standard_normal((40, 8))
    txt[:20] = img[:20] + 0.1 * txt[:20]
    got = pe.RetrievalEvaluator(chunk=16).eval_arrays(img, txt)
    assert got == je.RetrievalEvaluator(chunk=16).eval_arrays(img, txt)
    assert got.headline == got["i2t_r1"] > 0
    lines = [{"score": s.tolist(), "label": int(lb)}
             for s, lb in zip(scores, labels)]
    for r in range(2):
        (tmp_path / f"results.txt.rank{r}").write_text(
            "".join(json.dumps(x) + "\n" for x in lines[r::2]))
    merged = pe.merge_rank_results(str(tmp_path / "results.txt"))
    assert merged == je.merge_rank_results(str(tmp_path / "results.txt"))
    assert pe.ImageNetEvaluator().eval_jsonl(merged) == \
        je.ImageNetEvaluator().eval_jsonl(merged)
    built = pe.build_evaluator({"type": "imagenet",
                                "kwargs": {"topk": [1, 3]}})
    assert set(built.eval_arrays(scores, labels)) == {"top1", "top3", "n"}


def test_config_overrides_and_meters_match_jax():
    from declip_tpu.config import override as jax_override
    from declip_tpu.config import parse_config as jax_parse
    from declip_tpu.utils.meters import MeterGroup as JaxMeters
    from declip_tpu_torch.config import override, parse_config
    from declip_tpu_torch.utils.meters import MeterGroup

    text = "a: {b: {c: 1}, d: [1, 2]}\ne: x\n"
    port, jax = parse_config(text), jax_parse(text)
    for key, value in (("a.b.c", 5), ("a.new.deep", [1]), ("e.f", 2)):
        port, jax = override(port, key, value), jax_override(jax, key, value)
        assert port == jax
        assert port.get_path(key) == jax.get_path(key) == value
    assert port.get_path("a.zz", "dflt") == "dflt"
    meters, jax_meters = MeterGroup(3), JaxMeters(3)
    for v in (1.0, 4.0, 2.5, 8.0):
        meters.update({"loss": v, "t": 2 * v})
        jax_meters.update({"loss": v, "t": 2 * v})
    assert meters.summary() == jax_meters.summary()
    assert meters["loss"].count == 4 and "t" in meters


def test_scalar_writer_lines(tmp_path, monkeypatch):
    from declip_tpu_torch.utils.logging import ScalarWriter, create_logger

    monkeypatch.setenv("DECLIP_TB", "0")
    w = ScalarWriter(str(tmp_path / "events"))
    w.add_scalar("loss", np.float32(1.5), 3)
    w.close()
    row = json.loads((tmp_path / "events" / "scalars.jsonl").read_text())
    assert (row["step"], row["tag"], row["value"]) == (3, "loss", 1.5)
    logger = create_logger(str(tmp_path / "log.txt"), name="t_port")
    logger.info("hello")
    assert "hello" in (tmp_path / "log.txt").read_text()


def test_data_files_are_the_ports_own_and_packaged():
    """The prompt ensembles and the synonym table are copies inside the
    port (equal to the JAX package's), and pyproject ships them."""
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    pairs = [(repo / "declip_tpu_torch" / "data" / "prompts" / p.name, p)
             for p in sorted((repo / "declip_tpu" / "data" /
                              "prompts").iterdir())]
    pairs.append((repo / "declip_tpu_torch" / "tokenizer" / "data" /
                  "synonyms.json",
                  repo / "declip_tpu" / "tokenizer" / "data" /
                  "synonyms.json"))
    assert len(pairs) == 5
    for ours, theirs in pairs:
        assert ours.read_bytes() == theirs.read_bytes(), ours
    text = (repo / "pyproject.toml").read_text()
    assert '"declip_tpu_torch.data" = ["prompts/*"]' in text
    assert '"declip_tpu_torch.tokenizer" = ["data/*.json"]' in text
