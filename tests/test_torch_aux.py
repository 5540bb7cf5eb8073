"""The port's small host modules against the JAX package's:
``BpeTokenizer.decode``, the colored shapes of ``data/synthetic_shapes.py``,
mixup and CutMix (``utils/mixup.py``) and the crash handler
(``utils/debug.py``).

The tokenizer and the shapes are held bit for bit (the same numpy
generator on both sides). Mixup and CutMix are held on the JAX package's
own draws (λ, the permutation and the box centre taken from
``jax.random`` with its key splits), within atol 1e-6 for mixup and
exactly for CutMix; the port's own draws from a ``torch.Generator`` are
checked to be valid.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu_torch.utils import mixup

# ---------------------------------------------------------------- tokenizer


def test_decode_matches_jax():
    """Seeded id lists over the whole byte-level vocabulary of 515 (the
    one the repo ships), special tokens and bytes that are no valid UTF-8
    among them, and the rows ``tokenize`` makes, decode to JAX's strings."""
    from declip_tpu.tokenizer.bpe import BpeTokenizer as JaxTokenizer
    from declip_tpu_torch.tokenizer.bpe import BpeTokenizer

    jtok, tok = JaxTokenizer(None), BpeTokenizer(None)
    assert tok.vocab_size == jtok.vocab_size == 515
    rng = np.random.default_rng(0)
    lists = [rng.integers(0, 515, size=n).tolist()
             for n in (0, 1, 5, 17, 77, 200)]
    texts = ["a red square", "A photo of a naïve café, 2 dogs!", "héllo"]
    lists += [[int(i) for i in row if i] for row in tok.tokenize(texts)]
    for ids in lists:
        assert tok.decode(ids) == jtok.decode(ids), ids
    assert tok.decode(tok.encode("a red square")) == "a red square"


# ------------------------------------------------------------------ shapes


def test_shapes_match_jax_bit_for_bit():
    from declip_tpu.data import synthetic_shapes as jss
    from declip_tpu_torch.data import synthetic_shapes as ss

    assert ss.CLASSES == jss.CLASSES and ss.SHAPES == jss.SHAPES
    assert ss.COLORS == jss.COLORS
    for res in (16, 32):
        for color, shape in ss.CLASSES:
            a = ss.render(np.random.default_rng(res), color, shape, res)
            b = jss.render(np.random.default_rng(res), color, shape, res)
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b), (color, shape, res)
    imgs, idx = ss.render_class_batch(np.random.default_rng(5), 24, 32)
    jimgs, jidx = jss.render_class_batch(np.random.default_rng(5), 24, 32)
    assert np.array_equal(imgs, jimgs) and np.array_equal(idx, jidx)
    assert ss.captions(idx) == jss.captions(jidx)
    assert ss.captions(idx, "a photo of a {} {}") == jss.captions(
        jidx, "a photo of a {} {}")
    assert ss.class_prompts() == jss.class_prompts()
    assert len(ss.class_prompts()) == 16


# ------------------------------------------------------------ mixup/CutMix


def _batch(b=6, h=10, w=12):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    y = np.arange(b, dtype=np.int32)
    return x, y


@pytest.mark.parametrize("seed,alpha", [(0, 1.0), (1, 0.4), (2, 2.0),
                                        (3, 0.0)])
def test_mixup_apply_matches_jax_on_its_draws(seed, alpha):
    from declip_tpu.utils.mixup import mixup_data

    x, y = _batch()
    key = jax.random.PRNGKey(seed)
    want = mixup_data(key, jnp.asarray(x), jnp.asarray(y), alpha=alpha)
    r1, r2 = jax.random.split(key)
    lam = (jax.random.beta(r1, alpha, alpha) if alpha > 0
           else jnp.float32(1.0))
    perm = jax.random.permutation(r2, x.shape[0])
    got = mixup.mixup_apply(torch.from_numpy(x), torch.from_numpy(y),
                            torch.tensor(np.asarray(lam)),
                            torch.from_numpy(np.asarray(perm)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert float(got[3]) == float(want[3])


@pytest.mark.parametrize("seed,alpha", [(0, 1.0), (1, 0.4), (4, 2.0),
                                        (5, 0.0)])
def test_cutmix_apply_matches_jax_on_its_draws(seed, alpha):
    from declip_tpu.utils.mixup import cutmix_data, rand_bbox

    x, y = _batch()
    _, h, w, _ = x.shape
    key = jax.random.PRNGKey(seed)
    want = cutmix_data(key, jnp.asarray(x), jnp.asarray(y), alpha=alpha)
    r1, r2, r3 = jax.random.split(key, 3)
    lam = (jax.random.beta(r1, alpha, alpha) if alpha > 0
           else jnp.float32(1.0))
    perm = jax.random.permutation(r2, x.shape[0])
    s1, s2 = jax.random.split(r3)
    cx = int(jax.random.randint(s1, (), 0, w))
    cy = int(jax.random.randint(s2, (), 0, h))
    box = mixup.rand_bbox(h, w, torch.tensor(np.asarray(lam)), cx, cy)
    assert box == tuple(int(v) for v in rand_bbox(r3, h, w, lam))
    got = mixup.cutmix_apply(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(np.asarray(perm)), box)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w_ in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    assert got[3].dtype == torch.float32
    assert float(got[3]) == float(want[3])


def test_own_draws_are_valid():
    """λ in [0, 1] with Beta(α, α)'s mean and variance over many draws, a
    permutation, a box inside the image whose share λ_adj accounts for, the
    same draws from the same seed, and λ = 1 at α = 0."""
    x, y = _batch()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    g = torch.Generator().manual_seed(0)
    for alpha in (0.4, 1.0):
        lams = torch.stack([mixup.beta_draw(g, alpha) for _ in range(4000)])
        assert float(lams.min()) >= 0 and float(lams.max()) <= 1
        assert abs(float(lams.mean()) - 0.5) < 0.02
        want_var = 1 / (4 * (2 * alpha + 1))
        assert abs(float(lams.var()) - want_var) < 0.1 * want_var
    assert float(mixup.beta_draw(g, 0.0)) == 1.0
    for seed in range(8):
        mixed, ya, yb, lam = mixup.mixup_data(
            torch.Generator().manual_seed(seed), xt, yt)
        assert 0 <= float(lam) <= 1
        assert sorted(yb.tolist()) == y.tolist() and torch.equal(ya, yt)
        np.testing.assert_allclose(
            mixed.numpy(), float(lam) * x + (1 - float(lam)) * x[yb.numpy()],
            atol=1e-6)
        g = torch.Generator().manual_seed(seed)
        lam, perm, (cx, cy) = mixup.cutmix_draw(g, 6, 10, 12)
        x1, y1, x2, y2 = mixup.rand_bbox(10, 12, lam, cx, cy)
        assert 0 <= x1 <= x2 <= 12 and 0 <= y1 <= y2 <= 10
        mixed, _, yb, lam_adj = mixup.cutmix_data(
            torch.Generator().manual_seed(seed), xt, yt)
        assert torch.equal(yb, perm)
        inside = np.zeros((10, 12), bool)
        inside[y1:y2, x1:x2] = True
        assert np.array_equal(mixed.numpy()[:, inside],
                              x[perm.numpy()][:, inside])
        assert np.array_equal(mixed.numpy()[:, ~inside], x[:, ~inside])
        assert float(lam_adj) == pytest.approx(1 - inside.mean(), abs=1e-7)
    a = mixup.cutmix_draw(torch.Generator().manual_seed(3), 6, 10, 12)
    b = mixup.cutmix_draw(torch.Generator().manual_seed(3), 6, 10, 12)
    assert float(a[0]) == float(b[0]) and torch.equal(a[1], b[1])
    assert a[2] == b[2]


# ----------------------------------------------------------- crash handler


def _report(install, path):
    old_hook = sys.excepthook
    try:
        install(str(path))
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
    finally:
        sys.excepthook = old_hook
    return json.loads((path / "crash_report.json").read_text())


def test_crash_report_has_jax_keys(tmp_path, capfd):
    from declip_tpu.utils.debug import install_crash_handler as jax_install
    from declip_tpu_torch.utils.debug import install_crash_handler

    want = _report(jax_install, tmp_path / "jax")
    got = _report(install_crash_handler, tmp_path / "port")
    assert set(got) == set(want)
    assert got["type"] == want["type"] == "ValueError"
    assert got["message"] == want["message"] == "boom"
    assert got["argv"] == want["argv"]
    assert got["traceback"][-1] == want["traceback"][-1]
    assert got["devices"] == ["cpu"] and got["process_index"] == 0
    assert "crash report" in capfd.readouterr().err
