"""The port's on-device augmentation (declip_tpu_torch.data.device_aug), its
uint8 geometry presets and the train step's ``device_aug``, on the CPU.

JAX's PRNG streams have no torch counterpart, so the photometric ops are
held to JAX's on JAX's own draws: the test replays ``photometric_augment``'s
``jax.random`` calls (device_aug.py:86-126 of the JAX package) and feeds
those parameters to the port's ``photometric_apply``, fp32, atol 1e-5 (the
two sum the luma, the 3x3 hue product and the 9-tap blur in other orders:
a few fp32 ulps of values in [-2.2, 2.7]). The port's own draws are held to
the preset's gate probabilities and ranges, and to (seed, step) keying.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from declip_tpu.data import device_aug as jax_aug
from declip_tpu.data.transforms import (
    build_geometry_augmentation as jax_geometry,
)

from declip_tpu_torch.data import device_aug
from declip_tpu_torch.data.transforms import build_geometry_augmentation

B, SIZE = 8, 32
GATES = {"jitter": "p_jitter", "gray": "p_gray", "blur": "p_blur",
         "flip": "p_flip"}
DEFAULT_P = {"p_jitter": 0.8, "p_gray": 0.2, "p_blur": 0.5, "p_flip": 0.5}


def _crops(seed=0, b=B, channels=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, SIZE, SIZE, channels), np.uint8)


def _jax_draws(key, b, probs):
    """photometric_augment's draws from ``key``, as the port's params."""
    keys = jax.random.split(key, 10)

    def u(k, lo, hi, shape=(b, 1, 1, 1)):
        return np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi)
                          ).reshape(b)

    def gate(k, p, shape=(b, 1, 1, 1)):
        return np.asarray(jax.random.uniform(k, shape) < p).reshape(b)

    draws = {"jitter": gate(keys[0], probs["p_jitter"]),
             "brightness": u(keys[1], 0.6, 1.4),
             "contrast": u(keys[2], 0.6, 1.4),
             "saturation": u(keys[3], 0.6, 1.4),
             "hue": u(keys[4], -0.1, 0.1),
             "gray": gate(keys[5], probs["p_gray"]),
             "blur": gate(keys[6], probs["p_blur"], (b,)),
             "sigma": u(keys[7], 0.1, 2.0, (b,)),
             "flip": gate(keys[8], probs["p_flip"])}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gates", ["default", "closed", "open"])
def test_photometric_apply_matches_jax(seed, gates):
    probs = {"default": DEFAULT_P,
             "closed": {k: 0.0 for k in DEFAULT_P},
             "open": {k: 1.0 for k in DEFAULT_P}}[gates]
    x = _crops(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_aug.photometric_augment(key, jnp.asarray(x),
                                                  **probs))
    params = _jax_draws(key, B, probs)
    if gates != "default":
        for name in GATES:
            assert bool(params[name].all()) == (gates == "open"), name
            assert bool(params[name].any()) == (gates == "open"), name
    got = device_aug.photometric_apply(torch.from_numpy(x), params)
    assert got.dtype == torch.float32 and got.shape == (B, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("preset,views", [("MOCOV2", 2), ("SLIP", 3),
                                          ("STANDARD_CLIP", 1)])
def test_augment_views_weak_and_strong(preset, views):
    """Weak views are JAX's normalize_only (1e-6); strong views of the
    same crops take independent draws, so they differ."""
    view = _crops(3)
    crops = np.concatenate([view] * views, axis=-1)
    out = device_aug.augment_views(torch.from_numpy(crops), views=views,
                                   preset=preset, seed=5, step=7).numpy()
    assert out.shape == (B, SIZE, SIZE, 3 * views)
    weak = np.asarray(jax_aug.normalize_only(jnp.asarray(view)))
    strong = jax_aug._PRESET_STRONG_VIEWS[preset]
    assert list(device_aug.strong_views(preset, views)) == list(strong)
    outs = [out[..., 3 * v:3 * (v + 1)] for v in range(views)]
    for v, s in enumerate(strong):
        if not s:
            np.testing.assert_allclose(outs[v], weak, rtol=0, atol=1e-6)
    strong_outs = [o for o, s in zip(outs, strong) if s]
    for a, b in zip(strong_outs, strong_outs[1:]):
        assert np.abs(a - b).max() > 0.1


def test_draws_follow_the_preset():
    """Over 20k samples each gate opens within 4 sigma of its probability
    (0.8, 0.2, 0.5, 0.5), and every factor lies inside its range."""
    n = 20_000
    p = device_aug.photometric_params(torch.Generator().manual_seed(0), n)
    for name, prob in (("jitter", 0.8), ("gray", 0.2), ("blur", 0.5),
                       ("flip", 0.5)):
        assert p[name].dtype == torch.bool and p[name].shape == (n,)
        freq = float(p[name].float().mean())
        assert abs(freq - prob) <= 4 * np.sqrt(prob * (1 - prob) / n), name
    for name, (lo, hi) in (("brightness", (0.6, 1.4)),
                           ("contrast", (0.6, 1.4)),
                           ("saturation", (0.6, 1.4)),
                           ("hue", (-0.1, 0.1)), ("sigma", (0.1, 2.0))):
        v = p[name]
        assert float(v.min()) >= lo and float(v.max()) <= hi, name
        assert float(v.max() - v.min()) > 0.9 * (hi - lo), name


def test_draws_are_keyed_by_seed_and_step():
    crops = torch.from_numpy(np.concatenate([_crops(4)] * 2, axis=-1))

    def run(seed, step, dtype=torch.float32):
        return device_aug.augment_views(crops, views=2, seed=seed,
                                        step=step, dtype=dtype)

    a = run(0, 3)
    assert torch.equal(a, run(0, 3))
    assert not torch.equal(a, run(0, 4))
    assert not torch.equal(a, run(1, 3))
    # the two views take draws of their own
    assert not torch.equal(a[..., :3], a[..., 3:])
    half = run(0, 3, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, a.to(torch.bfloat16))
    with pytest.raises(TypeError, match="uint8"):
        device_aug.augment_views(crops.float(), views=2)


@pytest.fixture(scope="module")
def photo():
    rng = np.random.default_rng(11)
    return Image.fromarray(rng.integers(0, 256, (300, 420, 3), np.uint8))


@pytest.mark.parametrize("preset", ["MOCOV2", "SLIP", "STANDARD_CLIP",
                                    "ONECROP"])
def test_geometry_presets_match_jax(photo, preset):
    """The uint8 crops bit for bit on the same random.Random(seed); the
    transform survives a pickle round trip (process workers receive it)."""
    for seed in (0, 1):
        got = build_geometry_augmentation(preset, random.Random(seed))
        want = jax_geometry(preset, random.Random(seed))
        g, w = got(photo), want(photo)
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert g.shape[:2] == (224, 224)
        np.testing.assert_array_equal(g, w)
    t = build_geometry_augmentation(preset, random.Random(9))
    copy = pickle.loads(pickle.dumps(t))
    np.testing.assert_array_equal(copy(photo), t(photo))
    pickle.loads(pickle.dumps(build_geometry_augmentation(preset)))


def test_geometry_refuses_the_unported_presets():
    # AutoAugment and CLSA's views have no geometry-only variant, as in the
    # JAX package (they are host pipelines, data/transforms.py)
    for preset in ("CLSA", "AUTOAUG", "STANDARD"):
        with pytest.raises(KeyError, match="no geometry variant"):
            build_geometry_augmentation(preset)


def test_step_augments_on_the_device(tmp_path):
    """tiny_declip: a step with ``device_aug`` on a uint8 batch equals a
    step without it on the batch that augment_views gives with that step's
    key (the run's seed, step 0), bit for bit; both from one seeded
    start."""
    import os
    import shutil

    from declip_tpu_torch.config import override, parse_config
    from declip_tpu_torch.solver import Solver

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "experiments", "unit", "tiny_declip",
        "config.yaml")

    def solver(name, device_aug):
        exp = tmp_path / name
        exp.mkdir()
        shutil.copy(src, exp / "config.yaml")
        cfg = parse_config(str(exp / "config.yaml"))
        cfg = override(cfg, "data.test", [])
        cfg = override(cfg, "data.train.device_aug", device_aug)
        cfg = override(cfg, "seed", 3)
        cfg["_config_path"] = str(exp / "config.yaml")
        return Solver(cfg, device="cpu")

    aug, plain = solver("aug", True), solver("plain", False)
    loader = iter(aug._train_loader(-1))
    batch = aug._stage(next(loader))["tensors"]
    loader.close()
    assert batch["images"].dtype == torch.uint8
    views = device_aug.augment_views(batch["images"], views=2, seed=3,
                                     step=0)
    aug.state, m_aug = aug._train_step(aug.state, batch)
    plain.state, m_plain = plain._train_step(plain.state,
                                             dict(batch, images=views))
    assert float(m_aug["loss"]) == float(m_plain["loss"])
    assert np.isfinite(float(m_aug["loss"]))
    for (n, p), q in zip(aug.model.named_parameters(),
                         plain.model.parameters()):
        assert torch.equal(p, q), n
