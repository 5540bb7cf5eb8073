"""The port's optimizer pieces (declip_tpu_torch.optim) against the JAX
package's: parameter groups, LR schedules, and AdamW/Adam updates with
pconfig weight decay, each grad-clip stage and the frozen conv1.

The tiny CLIP's weights come from the JAX init and cross over through
``state_from_jax_variables``; gradients are numpy arrays made from a seed and
mapped the same way. Tolerance rtol 1e-6: both sides compute in fp32 in the
same order of operations (optax's), and differ by an fp32 rounding or two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry
from declip_tpu.optim.param_groups import group_labels as jax_group_labels
from declip_tpu.optim.param_groups import path_prefix_mask as jax_prefix_mask

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.optim import (
    global_norm,
    group_labels,
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
)

CFG = {"type": "clip_vitb32", "kwargs": {
    "image_encode": {"embed_dim": 32, "input_resolution": 32,
                     "patch_size": 8, "width": 64, "layers": 2, "heads": 2},
    "text_encode": {"embed_dim": 32, "transformer_width": 64,
                    "transformer_heads": 2, "transformer_layers": 2,
                    "vocab_size": 100},
}}
# the YFCC15M ViT-CLIP recipe's pconfig
PCONFIG = {g: {"weight_decay": 0} for g in
           ("bn_w", "bn_b", "ln_w", "ln_b", "linear_b", "conv_b",
            "logit_scale")}


@pytest.fixture(scope="module")
def jax_params():
    model = jax_model_entry(CFG)
    batch = {"images": jnp.zeros((1, 32, 32, 3), jnp.float32),
             "tokens": jnp.ones((1, 77), jnp.int32)}
    variables = jax.jit(
        lambda: model.init(jax.random.PRNGKey(0), batch, train=True))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _port_model(params):
    model = model_entry(CFG)
    model.load_state_dict(state_from_jax_variables({"params": params}),
                          strict=True)
    return model


def _leaf_trees(params):
    """(flax path, single-leaf params tree) for every leaf."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [p.key for p in path]
        tree = leaf
        for name in reversed(names):
            tree = {name: tree}
        yield names, tree


def test_groups_equal_jax_groups(jax_params):
    """Every port parameter lands in the JAX group of its counterpart —
    attn.in_proj_bias (a bare Parameter) included in linear_b."""
    labels = group_labels(_port_model(jax_params))
    jax_labels = jax_group_labels(jax_params)
    seen = {}
    for names, tree in _leaf_trees(jax_params):
        want = jax_labels
        for name in names:
            want = want[name]
        for key in state_from_jax_variables({"params": tree}):
            seen[key] = want
    assert seen == labels
    assert labels["visual.transformer.resblocks.0.attn.in_proj_bias"] == \
        "linear_b"
    assert labels["encode_text.ln_final.weight"] == "ln_w"
    assert labels["logit_scale"] == "logit_scale"
    assert labels["visual.conv1.weight"] == "default"


SCHEDULES = {
    "Cosine": ({"type": "Cosine", "kwargs": {
        "base_lr": 1e-4, "warmup_lr": 1e-3, "min_lr": 1e-5,
        "warmup_steps": 5}}, 40),
    "Cosine-nowarmup": ({"type": "Cosine", "kwargs": {
        "base_lr": 0.0, "warmup_lr": 1e-3}}, 30),
    "Step": ({"type": "Step", "kwargs": {
        "base_lr": 0.01, "warmup_lr": 0.1, "warmup_steps": 4,
        "lr_steps": [10, 20, 25], "lr_mults": [0.1, 0.5, 0.2]}}, 30),
    "StepDecay": ({"type": "StepDecay", "kwargs": {
        "base_lr": 0.01, "warmup_lr": 0.1, "warmup_steps": 3,
        "step_size": 7, "decay": 0.5}}, 40),
    "Poly": ({"type": "Poly", "kwargs": {
        "base_lr": 0.0, "warmup_lr": 0.2, "warmup_steps": 6,
        "power": 2.0}}, 40),
    "CosineEpoch": ({"type": "CosineEpoch", "kwargs": {
        "base_lr": 0.0, "warmup_lr": 0.4, "warmup_epoch": 1.5,
        "max_epoch": 4}}, 48),
    "StepEpoch": ({"type": "StepEpoch", "kwargs": {
        "base_lr": 0.0, "warmup_lr": 0.4, "warmup_steps": 2,
        "lr_epochs": [1, 2.5], "lr_mults": [0.1, 0.1]}}, 48),
    "yfcc15m": ({"type": "Cosine", "kwargs": {
        "base_lr": 0.0001, "warmup_lr": 0.001, "min_lr": 0.0,
        "warmup_steps": 2500, "max_iter": 128001}}, 3000),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    """Every step 0..max_iter: the same fp32 lr (rtol 1e-6, and atol at
    1e-7 of the peak for values near zero, the spacing of fp32 around the
    cosine's 1)."""
    cfg, max_iter = SCHEDULES[name]
    ipe = 12 if name.endswith("Epoch") else 1
    ours = scheduler_entry(cfg, max_iter=max_iter, iters_per_epoch=ipe)
    theirs = jax.jit(jax.vmap(jax_scheduler_entry(
        cfg, max_iter=max_iter, iters_per_epoch=ipe)))
    steps = np.arange(max_iter + 1)
    want = np.asarray(theirs(jnp.asarray(steps, jnp.int32)))
    got = np.array([ours(int(s)) for s in steps], np.float32)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * peak)


CLIPS = {
    "none": None,
    "norm-clips": {"type": "norm", "value": 0.5},
    "norm-keeps": {"type": "norm", "value": 1e6},
    "value": {"type": "value", "value": 0.01},
    "logit_scale_grad": {"type": "logit_scale_grad", "value": 0.001},
    "constant": {"type": "constant", "value": 0},
    "guard-only": {"type": "logit_scale_param_value", "value": 3,
                   "max_value": 6},
}


@pytest.mark.parametrize("kind", ["AdamW", "Adam"])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_update_matches_optax(jax_params, clip, kind):
    """Two updates of the YFCC15M recipe (betas 0.9/0.98, wd 0.1, zero decay
    for ln/bias/logit_scale) with the frozen conv1; each grad-clip stage."""
    grad_clip = CLIPS[clip]
    ocfg = {"type": kind, "kwargs": {"lr": 1e-3, "weight_decay": 0.1,
                                     "betas": [0.9, 0.98], "eps": 1e-8}}
    sched_cfg = {"type": "Cosine", "kwargs": {
        "base_lr": 1e-4, "warmup_lr": 1e-3, "warmup_steps": 2}}
    rng = np.random.default_rng(len(clip) * 7 + len(kind))
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1,
        jax_params) for _ in range(2)]

    sched = jax_scheduler_entry(sched_cfg, max_iter=10)
    tx = jax_optim_entry(
        ocfg, jax_params, sched, pconfig=PCONFIG, grad_clip=grad_clip,
        frozen_mask=jax_prefix_mask(jax_params, ("patch_embed",)))

    @jax.jit
    def two_updates(params):
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
        return params

    want = state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray,
                                          two_updates(jax_params))})

    model = _port_model(jax_params)
    params = dict(model.named_parameters())
    port_tx = optim_entry(
        ocfg, model, scheduler_entry(sched_cfg, max_iter=10),
        pconfig=PCONFIG, grad_clip=grad_clip,
        frozen_mask=path_prefix_mask(params,
                                     model.visual.frozen_param_paths()))
    state = port_tx.init(params)
    conv1 = model.visual.conv1.weight.detach().clone()
    for g in grads:
        port_tx.update_(state_from_jax_variables({"params": g}), state,
                        params)
    assert state.count == 2
    assert torch.equal(model.visual.conv1.weight, conv1)
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("kind", ["SGD", "LARS", "AdamW_SGD", "Adafactor"])
def test_unported_optimizers_raise(jax_params, kind):
    with pytest.raises(NotImplementedError, match="1.4"):
        optim_entry({"type": kind, "kwargs": {"lr": 0.1}},
                    _port_model(jax_params), lambda step: 0.1)


@pytest.mark.parametrize("shape", [(4096, 4096), (512, 49409)],
                         ids=["slip-predictor-sim", "mlm-head"])
def test_global_norm_matches_optax_on_large_tensors(shape):
    """``global_norm`` over a gradient as large as the reference configs'
    largest (SLIP's 4096 x 4096 ``predictor_sim`` layer, the MLM head's
    512 x 49409) and a small one, against optax's global norm and the
    float64 norm: rtol 1e-6. PyTorch's CPU norm kernels read 7e-4 low
    over the first."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=shape).astype(np.float32) * 0.02,
             rng.normal(size=(64,)).astype(np.float32)]
    exact = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in grads))
    got = float(global_norm([torch.from_numpy(g) for g in grads]))
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    np.testing.assert_allclose(want, exact, rtol=1e-6)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
