"""The port's host-side copies against the JAX package's originals.

Config parsing, the BPE tokenizer and the ONECROP preprocessing are plain
Python and numpy in both packages, so they must agree exactly: same
config trees, same token ids, bit-identical image arrays. Checkpoint
discovery, the ``.pth.tar`` reader and the model registry are checked on
their own.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import gzip
import os

import numpy as np
import pytest
import torch
from PIL import Image

from declip_tpu_torch.checkpoint import find_last_checkpoint
from declip_tpu_torch.config import parse_config
from declip_tpu_torch.convert import load_pth
from declip_tpu_torch.data.transforms import build_common_augmentation
from declip_tpu_torch.tokenizer.bpe import BpeTokenizer
from declip_tpu_torch.tokenizer.mlm import IGNORE_INDEX, mask_tokens
from declip_tpu_torch.utils.registry import MODELS, Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_CLIP = os.path.join(REPO, "experiments", "clip_experiments", "yfcc15m",
                        "yfcc15m_vit_clip", "config.yaml")
TEXTS = ["a photo of a cat", "The THE the, theater!", "  tabs\tand\nnewlines ",
         "café & naïve 3.14", "<|startoftext|>raw<|endoftext|>",
         "x" * 300]


def test_parse_config_matches_jax():
    from declip_tpu.config import parse_config as jax_parse

    assert parse_config(VIT_CLIP) == jax_parse(VIT_CLIP)
    cfg = parse_config(VIT_CLIP)
    assert cfg.model.type == "clip_vitb32"
    assert parse_config("a: {b: 1}").a.b == 1
    with pytest.raises(FileNotFoundError):
        parse_config("no/such/config.yaml")


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    """A tiny merge table in the CLIP file format (header line first)."""
    path = tmp_path_factory.mktemp("bpe") / "merges.txt.gz"
    table = ["#version: 0.2", "t h", "th e</w>", "c a", "ca t</w>",
             "p h", "o t", "ph ot", "phot o</w>", "e r"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(table) + "\n")
    return str(path)


@pytest.mark.parametrize("with_merges", [False, True],
                         ids=["byte-level", "merge-table"])
def test_tokenizer_matches_jax(with_merges, merges):
    from declip_tpu.tokenizer.bpe import BpeTokenizer as JaxTokenizer

    path = merges if with_merges else None
    ours, theirs = BpeTokenizer(path), JaxTokenizer(path)
    assert (ours.vocab_size, ours.sot_id, ours.eot_id) == \
        (theirs.vocab_size, theirs.sot_id, theirs.eot_id)
    assert ours.eot_id == ours.vocab_size - 1
    got = ours.tokenize(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, theirs.tokenize(TEXTS))
    assert got[-1, -1] == ours.eot_id  # truncated rows still end in eot
    if with_merges:
        assert ours.encoder["cat</w>"] in got[0]


@pytest.mark.parametrize("prob", [0.15, 0.5])
def test_mask_tokens_matches_jax(prob, merges):
    """MLM masking: the same numpy generator gives bit-equal masked tokens
    and labels, with the tokenizer's mask id (the vocab's third-last id)."""
    from declip_tpu.tokenizer.bpe import BpeTokenizer as JaxTokenizer
    from declip_tpu.tokenizer.mlm import mask_tokens as jax_mask_tokens

    tok = BpeTokenizer(merges)
    assert tok.mask_id == JaxTokenizer(merges).mask_id == tok.vocab_size - 3
    tokens = tok.tokenize(TEXTS * 4)
    kwargs = dict(mask_id=tok.mask_id, vocab_size=tok.vocab_size,
                  special_ids=(tok.sot_id, tok.eot_id), mlm_probability=prob)
    got = mask_tokens(tokens, rng=np.random.default_rng(5), **kwargs)
    want = jax_mask_tokens(tokens, rng=np.random.default_rng(5), **kwargs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    masked, labels = got
    selected = labels != IGNORE_INDEX
    assert selected.any() and (masked == tok.mask_id).any()
    assert not selected[(tokens == 0) | (tokens == tok.sot_id)
                        | (tokens == tok.eot_id)].any()


@pytest.mark.parametrize("aug", ["ONECROP", "ONECROP256", "ONECROP384"])
@pytest.mark.parametrize("size", [(300, 200), (199, 421), (256, 256)],
                         ids=["wide", "tall", "square"])
def test_onecrop_matches_jax(aug, size):
    from declip_tpu.data.transforms import build_common_augmentation as jax_aug

    pixels = np.random.default_rng(sum(size)).integers(
        0, 256, size=(size[1], size[0], 3), dtype=np.uint8)
    img = Image.fromarray(pixels)
    got = build_common_augmentation(aug)(img)
    crop = int(aug[7:] or 224)
    assert got.dtype == np.float32 and got.shape == (crop, crop, 3)
    np.testing.assert_array_equal(got, jax_aug(aug)(img))


def test_unported_augmentation_raises():
    # AutoAugment and CLSA's views are ported (tests/test_torch_ssl.py holds
    # them to the JAX package's); a name neither package defines raises
    for aug in ("AUTOAUG", "CLSA5-16-24"):
        assert callable(build_common_augmentation(aug))
    with pytest.raises(KeyError, match="undefined augmentation"):
        build_common_augmentation("NO_SUCH_AUG")


def test_find_last_checkpoint(tmp_path):
    assert find_last_checkpoint(str(tmp_path)) is None
    (tmp_path / "ckpt.msgpack").write_bytes(b"")  # the JAX format: ignored
    assert find_last_checkpoint(str(tmp_path)) is None
    for name, mtime in (("ckpt.pth.tar", 100), ("ckpt_10.pth.tar", 200),
                        ("ckpt_20.pth.tar", 200), ("ckpt_5.pth.tar", 150)):
        p = tmp_path / name
        p.write_bytes(b"")
        os.utime(p, (mtime, mtime))
    # newest mtime wins, the step breaks the tie
    assert find_last_checkpoint(str(tmp_path)).endswith("ckpt_20.pth.tar")
    os.utime(tmp_path / "ckpt.pth.tar", (300, 300))
    assert find_last_checkpoint(str(tmp_path)).endswith("ckpt.pth.tar")


TINY_CLIP = """
model:
    type: clip_vitb32
    kwargs:
        image_encode: {embed_dim: 32, input_resolution: 32, patch_size: 8,
                       width: 64, layers: 2, heads: 2}
        text_encode: {embed_dim: 32, transformer_width: 64,
                      transformer_heads: 2, transformer_layers: 2}
        clip: {use_allgather: False}
"""


def _seeded_state(seed):
    from declip_tpu_torch.models import model_entry

    cfg = parse_config(TINY_CLIP)
    model = model_entry({"type": cfg.model.type,
                         "kwargs": dict(cfg.model.kwargs)})
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.state_dict()


@pytest.mark.parametrize("files", [("ckpt.msgpack",),
                                   ("ckpt_10.msgpack", "ckpt_20.msgpack"),
                                   ("ckpt.msgpack", "ckpt.pth.tar"),
                                   ()],
                         ids=["jax-only", "jax-steps", "both", "empty"])
def test_load_eval_model_on_an_experiment_dir(tmp_path, files):
    """A directory with only the JAX package's msgpack checkpoints raises,
    naming the newest one and the command that converts it; a .pth.tar
    loads whatever lies beside it; no checkpoint gives the seeded init."""
    from declip_tpu_torch.tools._common import load_eval_model

    cfg = tmp_path / "config.yaml"
    cfg.write_text(TINY_CLIP)
    ckpts = tmp_path / "checkpoints"
    ckpts.mkdir()
    for i, name in enumerate(files):
        p = ckpts / name
        if name.endswith(".pth.tar"):
            torch.save({"model": _seeded_state(7), "last_iter": 3}, p)
        else:
            p.write_bytes(b"\x81\xa4step\x00")  # never parsed by the port
        os.utime(p, (100 + i, 100 + i))
    jax_only = files and not any(f.endswith(".pth.tar") for f in files)
    if jax_only:
        with pytest.raises(FileNotFoundError) as err:
            load_eval_model(str(cfg), device="cpu")
        msg = str(err.value)
        newest = str(ckpts / files[-1])
        assert (f"python -m declip_tpu.tools.convert --config {cfg} "
                f"--to_pth {newest} --out {ckpts / 'ckpt.pth.tar'}") in msg
        return
    got = load_eval_model(str(cfg), device="cpu").state_dict()
    want = _seeded_state(7 if files else 0)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_load_pth_strips_module_prefix(tmp_path):
    state = {"module.visual.proj": torch.ones(2), "logit_scale": torch.zeros(1)}
    path = tmp_path / "ckpt.pth.tar"
    torch.save({"model": state, "last_iter": 3}, path)
    got = load_pth(str(path))
    assert sorted(got) == ["logit_scale", "visual.proj"]
    assert torch.equal(got["visual.proj"], torch.ones(2))
    torch.save([1, 2], path)
    with pytest.raises(ValueError, match="'model' state dict"):
        load_pth(str(path))


def test_registry():
    reg = Registry("thing")
    reg.register(lambda **kw: kw, name="echo")
    assert reg.build({"type": "echo", "kwargs": {"a": 1}}, b=2) == \
        {"a": 1, "b": 2}
    with pytest.raises(KeyError, match="duplicate"):
        reg.register(lambda: None, name="echo")
    with pytest.raises(KeyError,
                       match="Known: clip_res101, clip_res50, clip_vitb16"):
        import declip_tpu_torch.models  # noqa: F401 — registers the factories

        MODELS.get("clip_r50")
