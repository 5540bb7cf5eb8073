"""Every ``loss_impl`` mode of the port (declip_tpu_torch.ops.contrastive)
against the JAX package's, on one process; the world-2 ring cases are in
tests/test_torch_dist.py.

- ``make_pair_loss`` of each kind (full, chunked, ring, sigmoid,
  sigmoid_chunked, sigmoid_ring) on the same unit features, a scale and a
  SigLIP bias: the loss, its gradients with respect to both features, the
  scale and the bias, and the accuracy proxy's logits and labels. JAX's
  ring kinds run as its Solver runs them, over a one-device mesh.
  Tolerance: rtol 1e-5, atol 1e-6 (fp32, the same sums in other orders).
- Each method's loss assembly (CLIP, SLIP, FILIP, DeCLIP with the NN bank
  term, DeFILIP) under ``chunked`` and ``sigmoid`` with a ``logit_bias``
  among the outputs: the total, every metric and the gradients with
  respect to every feature, same tolerance.
- The chunked kinds hold no [B, GB] tensor for their backward: the bytes
  that autograd saves, counted by ``saved_tensors_hooks``, stay under one
  [B, GB] fp32 matrix, where the full kinds save more than one.
- A model built with ``logit_bias_init`` (FILIP, DeCLIP, SLIP) carries the
  bias and puts it among its outputs.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from declip_tpu.ops import contrastive as jax_contrastive
from declip_tpu.train import method_losses as jax_method_losses

from declip_tpu_torch.models import model_entry
from declip_tpu_torch.ops import contrastive
from declip_tpu_torch.train import method_losses

RTOL, ATOL = 1e-5, 1e-6
KINDS = ("full", "chunked", "ring", "sigmoid", "sigmoid_chunked",
         "sigmoid_ring")
B, D = 12, 8
SCALE, BIAS = 5.0, -3.0


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _cfg(kind, **weights):
    return {"loss_impl": {"type": kind, "chunk_size": 5, "acc_window": 7},
            "clip_simsiam_loss_weight": weights,
            "filip_dense": {"impl": "xla"}}


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _t(x):
    return torch.tensor(np.asarray(x), requires_grad=True)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def pair_runs():
    """{kind: JAX's (loss, logits, labels, grads)} on one set of features,
    and the features."""
    rng = np.random.default_rng(0)
    img, txt = _unit(rng.normal(size=(B, D))), _unit(rng.normal(size=(B, D)))
    out = {}
    for kind in KINDS:
        pair = jax_contrastive.make_pair_loss(_cfg(kind), mesh=_mesh())

        def loss(i, t, s, b, pair=pair):
            res = pair(i, t, (s, b))
            return res[0], res

        (_, res), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(
                img, txt, jnp.float32(SCALE), jnp.float32(BIAS))
        out[kind] = jax.device_get((res, grads))
    return {"img": img, "txt": txt, "jax": out}


@pytest.mark.parametrize("kind", KINDS)
def test_pair_loss_matches_jax(pair_runs, kind):
    (loss, logits, labels), grads = pair_runs["jax"][kind]
    x = [_t(pair_runs["img"]), _t(pair_runs["txt"]), _t(np.float32(SCALE)),
         _t(np.float32(BIAS))]
    got = contrastive.make_pair_loss(_cfg(kind))(x[0], x[1], (x[2], x[3]))
    got[0].backward()
    _close(got[0].detach(), loss, f"{kind} loss")
    _close(got[1].detach(), logits, f"{kind} accuracy logits")
    np.testing.assert_array_equal(got[2].numpy(), labels)
    for name, t, g in zip(("img", "txt", "scale", "bias"), x, grads):
        # the softmax kinds leave the bias unused: JAX's gradient is 0
        _close(np.zeros_like(g) if t.grad is None else t.grad, g,
               f"{kind} d/d{name}")


def _outputs(rng, method):
    """A model's feature dict for ``method`` with a logit bias (numpy)."""
    def f(*shape):
        return _unit(rng.normal(size=shape))

    out = {"logit_scale": np.float32(SCALE), "logit_bias": np.float32(BIAS)}
    if method in ("clip", "slip", "filip"):
        out.update(image_embed=f(B, D), text_embed=f(B, D))
    if method == "slip":
        out.update(image_sim_1=f(B, D), image_sim_2=f(B, D))
    if method == "filip":
        out.update(dense_image=f(B, 5, D), dense_text=f(B, 6, D),
                   dense_image_sel=f(B, 3, D), dense_text_sel=f(B, 3, D),
                   logit_scale_dense=np.float32(4.0))
    if method in ("declip", "defilip"):
        out.update(image_embed_1=f(B, D), image_embed_2=f(B, D),
                   text_embed=f(B, D), text_embed_aug=f(B, D),
                   simsiam=(f(B, D), f(B, D), f(B, D), f(B, D)),
                   nn_text=(f(B, D),), nn_text_aug=(f(B, D),))
    if method == "defilip":
        out.update(dense_image_1=f(B, 5, D), dense_text=f(B, 6, D),
                   dense_image_1_sel=f(B, 3, D), dense_text_sel=f(B, 3, D),
                   logit_scale_dense=np.float32(4.0))
    return out


WEIGHTS = {"clip": {}, "slip": {},
           "filip": {"clip_loss": 1.0, "clip_dense_loss": 0.5},
           "declip": {"clip_loss": 1.0, "simsiam_loss": 1.0, "nn_text": 1.0},
           "defilip": {"clip_loss": 1.0, "nn_text": 1.0, "filip": 0.5}}
BANK = ("declip", "defilip")


def _call(mod, method, out, cfg):
    fn = getattr(mod, f"{method}_losses")
    if method in BANK:
        out = dict(out)
        nn, nn_aug = out.pop("nn_text"), out.pop("nn_text_aug")
        return fn(out, cfg, None, nn_text=nn, nn_text_aug=nn_aug)
    return fn(out, cfg, None)


@pytest.mark.parametrize("method", list(WEIGHTS))
@pytest.mark.parametrize("kind", ["chunked", "sigmoid"])
def test_method_losses_match_jax(method, kind):
    cfg = _cfg(kind, **WEIGHTS[method])
    out = _outputs(np.random.default_rng(len(method)), method)
    flat, tree = jax.tree_util.tree_flatten(out)

    def jax_loss(leaves):
        total, metrics = _call(jax_method_losses, method,
                               jax.tree_util.tree_unflatten(tree, leaves),
                               cfg)
        return total, metrics

    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(flat)
    leaves = [_t(x) for x in flat]
    total, metrics = _call(method_losses, method,
                           jax.tree_util.tree_unflatten(tree, leaves), cfg)
    total.backward()
    assert sorted(metrics) == sorted(jmetrics)
    _close(total.detach(), jtotal, "total")
    for key, v in jmetrics.items():
        _close(metrics[key].detach(), v, key)
    for i, (t, g) in enumerate(zip(leaves, jgrads)):
        _close(np.zeros_like(g) if t.grad is None else t.grad, g,
               f"d/d leaf {i}")


@pytest.mark.parametrize("kind,full", [("chunked", "full"),
                                       ("sigmoid_chunked", "sigmoid")])
def test_chunked_backward_holds_no_full_logits(kind, full):
    """What autograd keeps for the backward: under one [B, GB] fp32
    matrix for the chunked kind, over it for the full one (so the count
    would see the matrix were it kept)."""
    n = 256
    rng = np.random.default_rng(1)
    img = torch.tensor(_unit(rng.normal(size=(n, 16))), requires_grad=True)
    txt = torch.tensor(_unit(rng.normal(size=(n, 16))), requires_grad=True)
    scale = (torch.tensor(SCALE, requires_grad=True),
             torch.tensor(BIAS, requires_grad=True))

    def saved_bytes(k):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        cfg = {"loss_impl": {"type": k, "chunk_size": 16, "acc_window": 8}}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = contrastive.make_pair_loss(cfg)(img, txt, scale)[0]
        loss.backward()
        return total[0]

    matrix = n * n * 4
    assert saved_bytes(kind) < matrix
    assert saved_bytes(full) > matrix


def test_ring_over_a_tuple_of_axes_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 1.10"):
        contrastive.make_pair_loss({"loss_impl": "ring"},
                                   axis_name=("dcn", "data"))


@pytest.mark.parametrize("mtype", ["filip_vitb32", "declip_vitb32",
                                   "slip_vitb32"])
def test_logit_bias_model_carries_the_bias(mtype):
    """logit_bias_init builds a (1,) bias parameter at its value, as the
    JAX models do (FILIP's forward: the bias among the outputs)."""
    model = model_entry({"type": mtype, "kwargs": {
        "image_encode": {"embed_dim": 16, "input_resolution": 16,
                         "patch_size": 8, "width": 16, "layers": 1,
                         "heads": 2},
        "text_encode": {"embed_dim": 16, "transformer_width": 16,
                        "transformer_heads": 2, "transformer_layers": 1,
                        "vocab_size": 50},
        "clip": {"logit_bias_init": -10.0, "feature_dim": 16}}},
        device="meta")
    assert tuple(model.logit_bias.shape) == (1,)
    model = model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    assert float(model.logit_bias.detach()[0]) == -10.0
    if mtype == "filip_vitb32":
        out = model({"images": torch.zeros(2, 16, 16, 3),
                     "tokens": torch.ones(2, 77, dtype=torch.long)})
        assert float(out["logit_bias"].detach()) == -10.0
