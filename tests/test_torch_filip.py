"""The port's FILIP ViT-B/32 (declip_tpu_torch.models.filip_model) and its
training step against the JAX package's, on a tiny model (the
experiments/unit/tiny_filip sizes: width 64, 2 layers, top_k 4), from the JAX
init carried over by ``state_from_jax_variables``.

- the forward's outputs (MLM logits and labels, embeddings, the dense and
  top-k selected token features, both scales) and ``filip_losses`` with its
  gradients, rtol 1e-4;
- a 4-step fp32 trajectory of ``make_train_step`` under the YFCC15M FILIP
  recipe (clip 0, dense 1, mlm 0; AdamW wd 0.5) and with every term on
  (clip 0.4, dense 1, mlm 0.2), as tests/test_torch_train.py holds CLIP's,
  the key rows of ``in_proj_bias`` held to Adam's step bound as there;
- under the recipe, the parameters that only the weight-0 terms reach get a
  gradient of exactly zero in both packages and decay alike.

The port runs its default late interaction (the kernel route: on CPU tensors
the plain versions of K3, K4 and K5); JAX its default on the CPU (the
chunked XLA path).
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import numpy as np
import pytest
import torch
from test_torch_train import _assert_params_close

from declip_tpu.config import parse_config as jax_parse_config
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry
from declip_tpu.optim.param_groups import path_prefix_mask as jax_prefix_mask
from declip_tpu.train import make_train_step as jax_make_train_step
from declip_tpu.train import new_train_state as jax_new_train_state
from declip_tpu.train.method_losses import filip_losses as jax_filip_losses

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.filip_model import FILIP
from declip_tpu_torch.ops import filip_late_interaction as fli
from declip_tpu_torch.optim import (
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
)
from declip_tpu_torch.tokenizer.mlm import mask_tokens
from declip_tpu_torch.train import (
    make_loss_fn,
    make_train_step,
    method_of,
    new_train_state,
)
from declip_tpu_torch.train.method_losses import filip_losses

RES, VOCAB, B, STEPS = 32, 100, 8, 4
MASK, SOT, EOT = VOCAB - 3, VOCAB - 2, VOCAB - 1  # the BPE vocab's order
RTOL = ATOL = 1e-4
MODEL_CFG = {"type": "filip_vitb32", "kwargs": {
    "image_encode": {"embed_dim": 64, "input_resolution": RES,
                     "patch_size": 8, "width": 64, "layers": 2, "heads": 2},
    "text_encode": {"embed_dim": 64, "transformer_width": 64,
                    "transformer_heads": 2, "transformer_layers": 2,
                    "vocab_size": VOCAB},
    "clip": {"use_allgather": True, "text_mask_type": "MLM",
             "return_dense": True, "select_topk": True, "top_k": 4,
             "feature_dim": 64},
    "dtype": "float32",
}}
RECIPE = {"clip_loss": 0.0, "clip_dense_loss": 1.0, "masking_language": 0.0}
ALL_ON = {"clip_loss": 0.4, "clip_dense_loss": 1.0, "masking_language": 0.2}
GRAD_CLIP = {"type": "logit_scale_param_value", "value": 3, "max_value": 6}
# experiments/filip_experiments/yfcc15m/yfcc15m_vit_filip/config.yaml's
# optimizer, at a larger lr so that four steps move the weights
OPT = {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.5,
                                   "betas": [0.9, 0.98], "eps": 1e-8}}
PCONFIG = {g: {"weight_decay": 0} for g in
           ("bn_w", "bn_b", "ln_w", "ln_b", "linear_b", "conv_b",
            "logit_scale")}
SCHED = {"type": "Cosine", "kwargs": {"base_lr": 1e-4, "warmup_lr": 1e-3,
                                      "min_lr": 0.0, "warmup_steps": 2}}
MAX_ITER = 10
# what only the CLIP and MLM terms reach: under the recipe's weights of 0 for
# both, their gradient is exactly zero
ZERO_GRAD_UNDER_RECIPE = {
    "logit_scale", "visual.ln_post.weight", "visual.ln_post.bias",
    "visual.proj", "encode_text.text_projection.weight",
    "encode_text.text_projection.bias", "text_label_predictor.weight",
    "text_label_predictor.bias"}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((B, 77), np.int32)
    for r in range(B):
        length = int(rng.integers(5, 40))
        toks[r, 0], toks[r, length - 1] = SOT, EOT
        toks[r, 1:length - 1] = rng.integers(1, MASK, size=length - 2)
    mlm_tokens, mlm_labels = mask_tokens(
        toks, mask_id=MASK, vocab_size=VOCAB, special_ids=(SOT, EOT),
        rng=rng, mlm_probability=0.3)
    return {"images": rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
            "tokens": toks, "mlm_tokens": mlm_tokens.astype(np.int32),
            "mlm_labels": mlm_labels.astype(np.int32)}


def _torch_batch(batch):
    out = {"images": torch.from_numpy(batch["images"])}
    for key in ("tokens", "mlm_tokens", "mlm_labels"):
        out[key] = torch.from_numpy(batch[key]).long()
    return out


def _cfg(weights):
    return {"clip_simsiam_loss_weight": dict(weights),
            "grad_clip": dict(GRAD_CLIP)}


@pytest.fixture(scope="module")
def jax_init():
    model = jax_model_entry(MODEL_CFG)
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), _batch(),
                                           train=True))()
    return model, jax.tree_util.tree_map(np.asarray, variables["params"])


def _port_model(params):
    model = model_entry(MODEL_CFG)
    model.load_state_dict(state_from_jax_variables({"params": params}),
                          strict=True)
    return model


def test_forward_and_losses_match_jax(jax_init):
    model, params = jax_init
    batch = _batch(1)
    want = jax.jit(lambda p, b: model.apply({"params": p}, b, train=True))(
        params, batch)
    port = _port_model(params)
    assert isinstance(port, FILIP) and method_of(port) == "filip"
    got = port(_torch_batch(batch))
    assert sorted(got) == sorted(want)
    assert got["logit_scale_dense"].shape == ()
    for key, w in want.items():
        g = got[key].detach().numpy()
        assert g.shape == np.shape(w), key
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=1e-6,
                                   err_msg=key)
    for weights in (RECIPE, ALL_ON):
        cfg = _cfg(weights)
        jtotal, jmetrics = jax.jit(
            lambda o, cfg=cfg: jax_filip_losses(o, cfg, None))(want)
        total, metrics = filip_losses(got, cfg, None)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=RTOL)
        for key, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(v), rtol=RTOL, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("kind", ["moe"])
def test_unported_variants_raise(kind):
    """What no package trains raises at construction: a MoE ResNet tower,
    an unknown kwarg as in the JAX package. (The transformer towers take
    MoE: tests/test_torch_moe.py; filip_res50 builds:
    tests/test_torch_resnet.py; a SigLIP logit bias builds and trains
    since the sigmoid loss is ported: tests/test_torch_loss_impl.py.)"""
    image = {"embed_dim": 64, "layers": (1, 1, 1, 1), "width": 8,
             "heads": 4, "input_resolution": 64}
    if kind == "moe":
        image["moe"] = {"num_experts": 4}
    cfg = {"type": "filip_res50",
           "kwargs": {**MODEL_CFG["kwargs"], "image_encode": image}}
    with pytest.raises(TypeError, match="moe_experts"):
        model_entry(cfg)


def _jax_grads(model, params, batch, cfg):
    def loss(p):
        out = model.apply({"params": p}, batch, train=True)
        return jax_filip_losses(out, cfg, None)[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})


def test_recipe_gradients_match_jax_and_zero_where_unreached(jax_init):
    """Under the YFCC15M recipe's weights the loss's gradient matches JAX's,
    and the parameters only the weight-0 terms reach get exactly zero in
    both packages (they still decay: see the trajectory test)."""
    model, params = jax_init
    batch = _batch(2)
    cfg = _cfg(RECIPE)
    jloss, want = _jax_grads(model, params, batch, cfg)
    port = _port_model(params)
    named = dict(port.named_parameters())
    total, _ = make_loss_fn(cfg, "filip")(port, None, _torch_batch(batch))
    np.testing.assert_allclose(float(total.detach()), jloss, rtol=RTOL)
    grads = torch.autograd.grad(total, list(named.values()),
                                allow_unused=True)
    zero = set()
    for name, g in zip(named, grads):
        g = np.zeros(named[name].shape, np.float32) if g is None \
            else g.numpy()
        w = want[name].numpy()
        if not g.any():
            zero.add(name)
            assert not w.any(), name
            continue
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6, err_msg=name)
    assert zero == ZERO_GRAD_UNDER_RECIPE


def _run_jax(model, params, cfg, batch):
    sched = jax_scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = jax_optim_entry(OPT, params, sched, pconfig=PCONFIG,
                         grad_clip=GRAD_CLIP,
                         frozen_mask=jax_prefix_mask(params,
                                                     ("patch_embed",)))
    state = jax_new_train_state(params=params, batch_stats={},
                                opt_state=tx.init(params))
    jcfg = jax_parse_config("x: 0")
    jcfg.update(cfg)
    step = jax.jit(jax_make_train_step(model, tx, jcfg, sched))
    history = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return jax.device_get(state), history


@pytest.mark.parametrize("weights", [RECIPE, ALL_ON],
                         ids=["yfcc15m-recipe", "all-terms"])
def test_trajectory_matches_jax(jax_init, weights):
    model, params = jax_init
    batch = _batch()
    cfg = _cfg(weights)
    jstate, jhist = _run_jax(model, params, cfg, batch)

    port = _port_model(params)
    named = dict(port.named_parameters())
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, port, sched, pconfig=PCONFIG, grad_clip=GRAD_CLIP,
                     frozen_mask=path_prefix_mask(
                         named, port.visual.frozen_param_paths()))
    state = new_train_state(model=port, opt_state=tx.init(named))
    step = make_train_step(port, tx, cfg, sched)
    start = {n: p.detach().numpy().copy() for n, p in named.items()}
    tbatch = _torch_batch(batch)
    launches = fli.late_interaction_fwd.launches
    for i in range(STEPS):
        state, metrics = step(state, tbatch)
        want = jhist[i]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, err_msg=f"step {i} {key}")
        for key in ("clip_loss", "clip_dense_loss", "text_mlm_loss", "top1",
                    "top5", "logit_scale", "lr"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == want["update_skipped"] == 0.0
    assert fli.late_interaction_fwd.launches == launches  # CPU: no kernel

    lr_sum = sum(h["lr"] for h in jhist)
    final = {n: t.numpy() for n, t in state_from_jax_variables(
        {"params": jstate.params}).items()}
    got = {n: p.detach().numpy() for n, p in state.params.items()}
    _assert_params_close(got, final, start, lr_sum, "params")
    if weights is RECIPE:
        # zero gradient: decay only, p * (1 - lr * wd) per step, or no move
        # at all where the group's decay is 0 (biases, LayerNorm); the logit
        # scale moves only by the guard's clamp of its init log(1/0.07)
        # into [3, 6]
        assert float(got["logit_scale"][0]) == 3.0
        for name in ZERO_GRAD_UNDER_RECIPE - {"logit_scale"}:
            np.testing.assert_allclose(got[name], final[name], rtol=1e-6,
                                       atol=0, err_msg=name)
            decays = name.endswith(("proj", ".weight")) and "ln_" not in name
            moved = not np.array_equal(got[name], start[name])
            assert moved == decays, name
            if decays:
                np.testing.assert_allclose(
                    got[name], start[name] * np.prod(
                        [1 - h["lr"] * 0.5 for h in jhist]), rtol=1e-5,
                    err_msg=name)


RES50_CFG = {"type": "filip_res50", "kwargs": {
    "image_encode": {"embed_dim": 64, "layers": (1, 1, 1, 1), "width": 8,
                     "heads": 4, "input_resolution": 64},
    "text_encode": MODEL_CFG["kwargs"]["text_encode"],
    "clip": MODEL_CFG["kwargs"]["clip"], "dtype": "float32"}}
DENSE_CASES = {"vitb32": (MODEL_CFG, RES), "res50": (RES50_CFG, 64)}


def _seeded_port(cfg):
    """The port's seeded init, with random BatchNorm running statistics."""
    from declip_tpu_torch.models.layers import BatchNorm

    port = model_entry(cfg)
    gen = torch.Generator().manual_seed(0)
    port.init_weights(gen)
    for m in port.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                              generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=gen) + 0.5)
    return port


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_encoders_and_class_embeddings_match_jax(name):
    """``encode_image_dense`` (the tower in eval mode: a ResNet's running
    BatchNorm statistics, while the model stays in training mode) and
    ``encode_text_dense`` against JAX's, rtol 1e-4; the dense class
    embeddings of 5 classes x 3 prompts in chunks of 2 classes (the tail
    chunk padded) through the solver's ``batched_class_embeddings`` against
    the JAX solver's ``make_class_embed_fn``; and under bf16 the dtypes
    that reach the late interaction (JAX's, from ``jax.eval_shape``: both
    sides bf16, which K3 takes on its tensor-core route, so the port casts
    nothing)."""
    import jax.numpy as jnp

    from declip_tpu.convert_pth import torch_state_to_variables
    from declip_tpu.solver import (
        batched_class_embeddings as jax_class_embeddings,
    )
    from declip_tpu.solver import make_class_embed_fn
    from declip_tpu_torch.solver import batched_class_embeddings

    cfg, res = DENSE_CASES[name]
    port = _seeded_port(cfg).train()
    variables = torch_state_to_variables(port.state_dict())
    jmodel = jax_model_entry(cfg)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(B, res, res, 3)).astype(np.float32)
    ids = np.zeros((15, 77), np.int32)  # 5 classes x 3 prompts
    for r in range(15):
        length = int(rng.integers(5, 20))
        ids[r, 0], ids[r, length - 1] = SOT, EOT
        ids[r, 1:length - 1] = rng.integers(1, MASK, size=length - 2)
    want_img = jax.jit(lambda v, x: jmodel.apply(
        v, x, method="encode_image_dense", train=False))(variables, images)
    want_cls = jax_class_embeddings(make_class_embed_fn(
        lambda p, c: jmodel.apply({"params": p}, c,
                                  method="encode_text_dense"),
        3, 2), variables["params"], ids, 5, 3, 2)
    with torch.no_grad():
        got_img = port.encode_image_dense(torch.from_numpy(images))
        got_cls = batched_class_embeddings(
            port.encode_text_dense, ids.astype(np.int64), 5, 3, 2, "cpu")
    assert port.training and port.visual.training
    assert got_img.shape == (B, 16 if name == "vitb32" else 4, 256)
    assert got_cls.shape == (5, 77, 256)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                               rtol=RTOL, atol=1e-6)

    bf16 = {**cfg, "kwargs": {**cfg["kwargs"], "dtype": "bfloat16"}}
    jb = jax_model_entry(bf16)
    img_t = jax.eval_shape(lambda v, x: jb.apply(
        v, x, method="encode_image_dense", train=False), variables, images)
    txt_t = jax.eval_shape(lambda p, c: jb.apply(
        {"params": p}, c, method="encode_text_dense"),
        variables["params"], ids)
    assert img_t.dtype == txt_t.dtype == jnp.bfloat16
    pb = model_entry(bf16).eval()
    pb.load_state_dict(port.state_dict())
    with torch.no_grad():
        assert pb.encode_image_dense(
            torch.from_numpy(images[:2])).dtype == torch.bfloat16
        assert batched_class_embeddings(
            pb.encode_text_dense, ids[:6].astype(np.int64), 2, 3, 2,
            "cpu").dtype == torch.bfloat16
