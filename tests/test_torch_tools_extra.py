"""The port's text visualisation, linear probe and learnability run
(``declip_tpu_torch/tools/{text_visualize,linear_probe,learnability}.py``)
against the JAX package's.

- ``text_visualize`` on ``experiments/unit/tiny_clip`` from the weights
  that JAX initialised, carried across: cosines within 1e-5 and the PCA
  within 1e-4 up to each component's sign, the same JSON keys and the
  same nearest-text lines.
- ``train_probe`` on one set of seeded features: ``w`` and ``b`` after 2
  epochs within rtol 1e-4, atol 1e-6 (fp32 AdamW, summation order only),
  and the same top-1; ``linear_probe.main`` on ``--read-from synthetic``.
- The learnability run's ``make_batch`` bit for bit against
  ``experiments/learnability_tpu.py`` (loaded by path) for both recipes,
  with and without a pool; its worker-built ``batch_stream`` the same
  batches in the same order; and its CLI for 2 steps on the CPU.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import importlib.util
import json
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
TEXTS = "a cat,a dog,a car,a red square,a photo of a blue circle"

# ----------------------------------------------------------- text_visualize


@pytest.fixture(scope="module")
def tiny_clip_pair(tmp_path_factory):
    """(JAX experiment dir, port experiment dir) with one set of weights:
    JAX's ``load_eval_model`` initialises its model (no checkpoint), and
    those variables, carried across, are the port's ``ckpt.pth.tar``."""
    from declip_tpu.tools._common import load_eval_model
    from declip_tpu_torch.convert import state_from_jax_variables

    root = tmp_path_factory.mktemp("text_viz")
    dirs = {side: root / side for side in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
        shutil.copy(REPO / "experiments" / "unit" / "tiny_clip" /
                    "config.yaml", d / "config.yaml")
    _, variables = load_eval_model(str(dirs["jax"] / "config.yaml"))
    (dirs["port"] / "checkpoints").mkdir()
    state = state_from_jax_variables(jax.device_get(variables))
    torch.save({"model": state, "last_iter": 0},
               dirs["port"] / "checkpoints" / "ckpt.pth.tar")
    return dirs


def _nearest_lines(out):
    return [line for line in out.splitlines() if "-> nearest" in line]


def test_text_visualize_matches_jax(tiny_clip_pair, tmp_path, capsys):
    from declip_tpu.tools import text_visualize as jax_viz
    from declip_tpu_torch.tools import _common, text_visualize

    outs = {side: str(tmp_path / f"{side}.json") for side in tiny_clip_pair}
    jax_viz.main(["--config", str(tiny_clip_pair["jax"] / "config.yaml"),
                  "--texts", TEXTS, "--out", outs["jax"]])
    jax_lines = _nearest_lines(capsys.readouterr().out)
    cfg = str(tiny_clip_pair["port"] / "config.yaml")
    got = text_visualize.main(["--config", cfg, "--texts", TEXTS, "--out",
                               outs["port"], "--device", "cpu"])
    assert _nearest_lines(capsys.readouterr().out) == jax_lines
    want = json.load(open(outs["jax"]))
    assert json.load(open(outs["port"])) == got
    assert list(got) == list(want) == ["texts", "pca_2d",
                                       "cosine_similarity"]
    assert got["texts"] == want["texts"]
    # unrounded port values against JAX's 5-place JSON
    emb = text_visualize.embed_texts(
        _common.load_eval_model(cfg, "cpu"), got["texts"])
    sim = emb @ emb.T
    np.testing.assert_allclose(sim, np.asarray(want["cosine_similarity"]),
                               atol=1e-5, rtol=0)
    assert np.array_equal(np.round(sim, 5), got["cosine_similarity"])
    pca, ref = text_visualize.pca_2d(emb), np.asarray(want["pca_2d"])
    for c in range(2):
        sign = np.sign(pca[:, c] @ ref[:, c])
        np.testing.assert_allclose(sign * pca[:, c], ref[:, c], atol=1e-4,
                                   rtol=0)


# ------------------------------------------------------------- linear probe


def test_train_probe_matches_jax():
    """The JAX rule on seeded features: 70 rows at batch 32 (a short last
    batch padded from the order's head), 4 classes, 2 epochs."""
    from declip_tpu.tools.linear_probe import train_probe as jax_probe
    from declip_tpu_torch.tools.linear_probe import train_probe

    rng = np.random.default_rng(0)
    centres = rng.normal(size=(4, 16))
    ty = rng.integers(0, 4, 70).astype(np.int32)
    vy = rng.integers(0, 4, 40).astype(np.int32)
    tx = (centres[ty] + rng.normal(size=(70, 16))).astype(np.float32)
    vx = (centres[vy] + rng.normal(size=(40, 16))).astype(np.float32)
    kw = dict(epochs=2, batch_size=32, seed=3)
    want, want_top1 = jax_probe(tx, ty, vx, vy, **kw)
    got, top1 = train_probe(tx, ty, vx, vy, **kw)
    for k in ("w", "b"):
        assert got[k].shape == np.asarray(want[k]).shape
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-6)
    assert np.abs(got["w"]).max() > 1e-3  # the head moved
    assert top1 == want_top1


def test_linear_probe_main_on_synthetic(tmp_path, capsys):
    """``main`` with ``--read-from synthetic`` metas: the JSON line's keys
    and counts, and a top-1 in [0, 100]; the seeded tiny CLIP on the
    CPU."""
    from declip_tpu_torch.tools import linear_probe

    shutil.copy(REPO / "experiments" / "unit" / "tiny_clip" / "config.yaml",
                tmp_path / "config.yaml")
    rng = np.random.default_rng(0)
    for name, n in (("train.txt", 12), ("val.txt", 6)):
        (tmp_path / name).write_text("".join(
            f"synthetic_{i}.png {int(rng.integers(0, 3))}\n"
            for i in range(n)))
    res = linear_probe.main([
        "--config", str(tmp_path / "config.yaml"),
        "--meta", str(tmp_path / "train.txt"),
        "--val-meta", str(tmp_path / "val.txt"),
        "--read-from", "synthetic", "--epochs", "2", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res
    assert list(res) == ["linear_probe_top1", "n_train", "n_val"]
    assert (res["n_train"], res["n_val"]) == (12, 6)
    assert 0 <= res["linear_probe_top1"] <= 100


# ------------------------------------------------------------- learnability


@pytest.fixture(scope="module")
def jax_learn():
    spec = importlib.util.spec_from_file_location(
        "learnability_tpu", REPO / "experiments" / "learnability_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("recipe", ["declip", "clip"])
@pytest.mark.parametrize("pool", [0, 24])
def test_make_batch_matches_jax(jax_learn, recipe, pool):
    """Two batches in a row from one generator (so the generator's state
    after the first is held too), with and without a pool."""
    from declip_tpu.tokenizer import get_tokenizer as jax_tokenizer
    from declip_tpu_torch.tokenizer import get_tokenizer
    from declip_tpu_torch.tools import learnability

    jtok, tok = jax_tokenizer(None), get_tokenizer(None)
    jpool = (jax_learn.Pool(np.random.default_rng(1234), pool, 32)
             if pool else None)
    tpool = (learnability.Pool(np.random.default_rng(1234), pool, 32)
             if pool else None)
    if pool:
        assert np.array_equal(tpool.imgs, jpool.imgs)
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        want, widx = jax_learn.make_batch(jrng, jtok, 12, jpool, recipe)
        got, idx = learnability.make_batch(rng, tok, 12, tpool, recipe)
        assert np.array_equal(idx, widx)
        assert list(got) == list(want)
        for k, v in want.items():
            g = got[k].numpy()
            assert g.dtype == np.asarray(v).dtype, k
            assert np.array_equal(g, np.asarray(v)), k
    if recipe == "declip":
        assert got["images"].shape == (12, 32, 32, 6)
        assert (got["mlm_labels"] != -100).any()


@pytest.mark.parametrize("pool", [0, 24])
def test_batch_stream_is_make_batch_in_order(pool):
    """The learnability run's batches, built ahead by a spawned worker from
    a copy of the generator, are ``batch_arrays``' on that generator, one
    after the other; the caller's generator does not move."""
    from declip_tpu_torch.data.shapes_batches import (
        Pool,
        batch_arrays,
        batch_stream,
    )
    from declip_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(None)
    tpool = Pool(np.random.default_rng(1234), pool, 32) if pool else None
    rng, ref = np.random.default_rng(5), np.random.default_rng(5)
    got = list(batch_stream(rng, 12, 3, tpool, "declip", ahead=2))
    assert len(got) == 3
    for batch in got:
        want, _ = batch_arrays(ref, tok, 12, tpool, "declip")
        assert list(batch) == list(want)
        for k, v in want.items():
            assert batch[k].dtype == v.dtype, k
            assert np.array_equal(batch[k], v), k
    assert (rng.bit_generator.state
            == np.random.default_rng(5).bit_generator.state)


def test_learnability_cli_two_steps(capsys):
    """``python -m declip_tpu_torch.tools.learnability`` for 2 steps on the
    CPU with a pool of 32: the JAX script's JSON keys, finite losses, the
    device as ``backend``."""
    from declip_tpu_torch.tools import learnability

    res = learnability.main(["--steps", "2", "--device", "cpu", "--pool",
                             "32", "--batch", "16"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res
    assert list(res) == ["recipe", "pool", "seed", "backend", "steps",
                         "batch", "first_loss", "last_loss",
                         "zero_shot_top1", "chance", "train_steps_per_s"]
    assert res["backend"] == "cpu" and res["pool"] == 32
    assert np.isfinite([res["first_loss"], res["last_loss"]]).all()
    assert 0 <= res["zero_shot_top1"] <= 1


def test_learnability_refuses_absent_cuda(monkeypatch):
    from declip_tpu_torch.tools import learnability

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        learnability.main(["--steps", "1"])
