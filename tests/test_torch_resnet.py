"""The port's ModifiedResNet (declip_tpu_torch.models.resnet) against the JAX
package's, at layers (1, 1, 1, 1), width 8, input_resolution 64 (a 2x2
grid), 4 heads, fp32, from the JAX init carried over by
``state_from_jax_variables`` with random running statistics:

- the training forward (batch statistics) and the eval forward (running
  statistics), with ``return_dense`` and ``return_feature``;
- the running statistics after one training forward against JAX's
  ``batch_stats`` (flax updates the running variance with the biased batch
  variance, torch's own BatchNorm with the unbiased one), with global and
  grouped (``bn_stats_groups=2``) statistics;
- ``attnpool_all_res`` at a 1x1 grid (the positional embedding resized with
  antialiasing) and ``fc_embed``, at the trained grid and through the
  mean+fc head at the smaller one;
- the gradient with respect to the input;
- ``clip_res50`` served through ``load_eval_model`` from a reference-format
  checkpoint (eval mode, running statistics) against JAX's ``train=False``
  image embedding, and ``filip_res50``'s forward and losses against JAX's
  (these two in fp32 on both sides).

The JAX side runs in float64 (``jax.enable_x64``, the module's ``dtype`` and
``bn_stats_dtype`` float64) on the same fp32 weights, and the port in fp32
is held to it. In fp32, flax's BatchNorm takes the batch variance as
E[x^2] - E[x]^2, whose rounding alone puts JAX's fp32 training forward
2.5e-5 from its fp64 one on the dense tokens here, where the port's fp32
forward is 3.8e-6 from it; against the fp64 reference the tolerances below
measure the port's own error.

Tolerances: rtol 1e-4, atol 1e-5 on outputs and gradients; 1e-6 relative on
the statistics.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.models.resnet import ModifiedResNet as JaxResNet
from declip_tpu.tools.convert import variables_to_torch_state
from declip_tpu.train.method_losses import filip_losses as jax_filip_losses

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.layers import BatchNorm, commit_bn_stats
from declip_tpu_torch.models.resnet import ModifiedResNet
from declip_tpu_torch.tools._common import load_eval_model
from declip_tpu_torch.train import method_of
from declip_tpu_torch.train.method_losses import filip_losses

RES, B = 64, 4
KW = dict(layers=(1, 1, 1, 1), embed_dim=16, heads=4, input_resolution=RES,
          width=8)
RTOL, ATOL, STATS_RTOL = 1e-4, 1e-5, 1e-6
VARIANTS = {"plain": {}, "groups2": {"bn_stats_groups": 2},
            "fc_embed": {"fc_embed": True},
            "all_res": {"attnpool_all_res": True}}


def _images(seed, res=RES):
    return np.random.default_rng(seed).normal(
        size=(B, res, res, 3)).astype(np.float32)


def _random_stats(stats, rng):
    """Running statistics away from their init, so that the eval forward
    reads them."""
    if isinstance(stats, dict):
        return {k: _random_stats(v, rng) for k, v in stats.items()}
    shape = np.shape(stats)
    return rng.uniform(0.5, 1.5, shape).astype(np.float32) \
        if np.all(np.asarray(stats) == 1) else \
        rng.normal(0, 0.1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def towers():
    """{variant: (fp64 jax module, fp32 numpy variables)}; the variants
    with plain's parameter tree share its variables (one init each)."""
    out, inits = {}, {}
    for name, extra in VARIANTS.items():
        m = JaxResNet(**KW, **extra)
        key = "fc" if extra.get("fc_embed") else "plain"
        if key not in inits:
            v = jax.jit(lambda m=m: m.init(jax.random.PRNGKey(0),
                                           jnp.zeros((B, RES, RES, 3)),
                                           train=False))()
            v = jax.tree_util.tree_map(np.asarray, v)
            inits[key] = {"params": v["params"],
                          "batch_stats": _random_stats(
                              v["batch_stats"], np.random.default_rng(1))}
        out[name] = (JaxResNet(**KW, **extra, dtype=jnp.float64,
                               bn_stats_dtype=jnp.float64), inits[key])
    return out


@pytest.fixture(scope="module")
def plain_train(towers):
    """JAX's training forward of the plain tower on the images of seed 2,
    with ``return_dense`` and ``return_feature``: (outputs, mutated)."""
    m, v = towers["plain"]
    return _jax_apply(m, v, _images(2), True, return_dense=True,
                      return_feature=True)


def _port(name, variables):
    model = ModifiedResNet(**KW, **VARIANTS[name])
    model.load_state_dict(state_from_jax_variables(variables), strict=True)
    return model


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_apply(m, variables, x, train, **kw):
    """m.apply in float64 -> numpy."""
    with jax.enable_x64(True):
        out = jax.jit(lambda v, x: m.apply(v, x, train=train, mutable=(
            ["batch_stats"] if train else False), **kw))(_f64(variables),
                                                         _f64(x))
        return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _bn_stats(model):
    return {n: (m.running_mean.numpy(), m.running_var.numpy())
            for n, m in model.named_modules() if isinstance(m, BatchNorm)}


def _jax_bn_stats(stats, prefix=""):
    """{port module name: (mean, var)} from a flax batch_stats tree."""
    out = {}
    for k, v in stats.items():
        if k == "BatchNorm_0":
            out[prefix] = (np.asarray(v["mean"]), np.asarray(v["var"]))
            continue
        name = {"downsample_conv": "downsample.0",
                "downsample_bn": "downsample.1"}.get(k, k)
        if name.startswith("layer") and "_" in name:
            name = name.replace("_", ".")
        out.update(_jax_bn_stats(v, f"{prefix}.{name}" if prefix else name))
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_jax(towers, plain_train, train):
    m, v = towers["plain"]
    x = _images(2)
    want = plain_train[0] if train else _jax_apply(
        m, v, x, False, return_dense=True, return_feature=True)
    model = _port("plain", v).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_dense=True,
                    return_feature=True)
    assert [tuple(t.shape) for t in got] == [(B, 16), (B, 4, 256), (B, 16)]
    for what, g, w in zip(("pooled", "dense", "feature"), got, want):
        _close(g.numpy(), w, what)


@pytest.mark.parametrize("variant", ["plain", "groups2"])
def test_running_stats_after_a_training_forward(towers, plain_train,
                                                variant):
    """One training forward, then the commit the train step makes: every
    BatchNorm's running mean and biased-variance update as flax's."""
    m, v = towers[variant]
    x = _images(2)
    (out, _, _), mutated = plain_train if variant == "plain" else \
        _jax_apply(m, v, x, True, return_dense=True, return_feature=True)
    model = _port(variant, v).train()
    before = {k: (a.copy(), b.copy()) for k, (a, b) in
              _bn_stats(model).items()}
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), out, "pooled")
    assert _bn_stats(model).keys() == before.keys()
    for name, (mean, var) in _bn_stats(model).items():  # pending, not yet
        np.testing.assert_array_equal(mean, before[name][0])
        np.testing.assert_array_equal(var, before[name][1])
    commit_bn_stats(model)
    want = _jax_bn_stats(mutated["batch_stats"])
    got_stats = _bn_stats(model)
    assert sorted(got_stats) == sorted(want)
    for name, (mean, var) in got_stats.items():
        _close(mean, want[name][0], f"{name} running_mean", STATS_RTOL, 1e-7)
        _close(var, want[name][1], f"{name} running_var", STATS_RTOL, 1e-7)


@pytest.mark.parametrize("variant,res", [("all_res", 32), ("fc_embed", RES),
                                         ("fc_embed", 32)],
                         ids=["attnpool_all_res-1x1", "fc_embed",
                              "fc_embed-mean_fc-1x1"])
def test_heads_at_other_grids(towers, variant, res):
    """attnpool at a 1x1 grid (its 2x2 positional grid resized with
    antialiasing), and fc_embed's attnpool + fc and mean + fc heads."""
    m, v = towers[variant]
    x = _images(4, res)
    want = _jax_apply(m, v, x, False, return_feature=True)
    model = _port(variant, v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_feature=True)
    for what, g, w in zip(("pooled", "feature"), got, want):
        assert tuple(g.shape) == np.shape(w), what
        _close(g.numpy(), w, what)


def test_mean_fc_head_needs_fc(towers):
    _, v = towers["plain"]
    with pytest.raises(ValueError, match="mean\\+fc"):
        _port("plain", v).eval()(torch.zeros(1, 32, 32, 3))


def test_input_gradient_matches_jax(towers):
    m, v = towers["plain"]
    x = _images(5)
    r = np.random.default_rng(6).normal(size=(B, 16)).astype(np.float32)

    def loss(v, x):
        out, _ = m.apply(v, x, train=True, mutable=["batch_stats"])
        return jnp.sum(out * r)

    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax.grad(loss, argnums=1))(_f64(v),
                                                              _f64(x)))
    model = _port("plain", v).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt) * torch.from_numpy(r)).sum().backward()
    _close(xt.grad.numpy(), want, "d input")


TOWERS = {"image_encode": {"embed_dim": 16, "layers": [1, 1, 1, 1],
                           "width": 8, "heads": 4, "input_resolution": RES},
          "text_encode": {"embed_dim": 16, "transformer_width": 32,
                          "transformer_heads": 2, "transformer_layers": 1,
                          "vocab_size": 100}}
SERVE_CONFIG = f"""
model:
    type: clip_res50
    kwargs:
        image_encode: {TOWERS["image_encode"]}
        text_encode: {TOWERS["text_encode"]}
        clip: {{use_allgather: False}}
"""


def _init_jax(cfg, batch):
    """-> (jax model, numpy variables with random running statistics)."""
    m = jax_model_entry(cfg)
    v = jax.jit(lambda: m.init(jax.random.PRNGKey(0), batch, train=True))()
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["batch_stats"] = _random_stats(v["batch_stats"],
                                     np.random.default_rng(1))
    return m, v


def test_clip_res50_served_by_load_eval_model(tmp_path):
    """A clip_res50 experiment's checkpoint in the reference's format (as
    ``declip_tpu.tools.convert --to_pth`` writes it, plus the reference
    BatchNorm's ``num_batches_tracked``) loads through ``load_eval_model``
    in eval mode, and its image embedding is JAX's ``train=False`` one."""
    cfg = {"type": "clip_res50",
           "kwargs": {**TOWERS, "clip": {"use_allgather": False}}}
    x = _images(7)
    batch = {"images": x, "tokens": np.ones((B, 77), np.int32)}
    m, v = _init_jax(cfg, batch)
    want = jax.jit(lambda v, x: m.apply(v, x, train=False,
                                        method="encode_image"))(v, x)
    state = variables_to_torch_state(v)
    state["visual.bn1.num_batches_tracked"] = torch.tensor(5)
    (tmp_path / "config.yaml").write_text(SERVE_CONFIG)
    (tmp_path / "checkpoints").mkdir()
    torch.save({"model": state, "last_iter": 5},
               tmp_path / "checkpoints" / "ckpt.pth.tar")
    model = load_eval_model(str(tmp_path / "config.yaml"), device="cpu")
    assert not model.training and method_of(model) == "clip"
    with torch.inference_mode():
        got = model.encode_image(torch.from_numpy(x)).numpy()
    _close(got, want, "image embedding")


def test_filip_res50_matches_jax():
    """filip_res50's forward (the ResNet's dense tokens through
    ``image_mapping``, 2048 = width*32 wide at full size) and its losses,
    in training mode."""
    cfg = {"type": "filip_res50", "kwargs": {
        **TOWERS, "clip": {"use_allgather": True, "return_dense": True,
                           "dense_embed_dim": 16}}}
    rng = np.random.default_rng(8)
    tokens = rng.integers(1, 99, (B, 77)).astype(np.int32)
    tokens[:, 20] = 99  # <|endoftext|>
    batch = {"images": _images(8), "tokens": tokens}
    m, v = _init_jax(cfg, batch)
    want, _ = jax.jit(lambda v, b: m.apply(
        v, b, train=True, mutable=["batch_stats"]))(v, batch)
    port = model_entry(cfg)
    port.load_state_dict(state_from_jax_variables(v), strict=True)
    assert method_of(port) == "filip"
    assert port.image_mapping.in_features == 8 * 32
    got = port.train()({"images": torch.from_numpy(batch["images"]),
                        "tokens": torch.from_numpy(tokens).long()})
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        _close(got[key].detach().numpy(), w, key)
    lcfg = {"clip_simsiam_loss_weight": {"clip_loss": 0.4,
                                         "clip_dense_loss": 1.0}}
    jtotal, jmetrics = jax.jit(lambda o: jax_filip_losses(o, lcfg, None))(
        want)
    total, metrics = filip_losses(got, lcfg, None)
    _close(float(total.detach()), float(jtotal), "loss")
    for key, w in jmetrics.items():
        _close(float(metrics[key].detach()), float(w), key)
