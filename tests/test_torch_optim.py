"""The port's optimizer pieces (declip_tpu_torch.optim) against the JAX
package's: parameter groups, LR schedules, AdamW/Adam updates with
pconfig weight decay, each grad-clip stage and the frozen conv1, and every
other optimizer type of the JAX package's ``optim_entry``.

The tiny CLIP's weights (two layers a tower) come from the JAX init and
cross over through ``state_from_jax_variables``; gradients are numpy arrays
made from a seed and mapped the same way. Tolerance rtol 1e-6: both sides
compute in fp32 in the same order of operations (optax's), and differ by an
fp32 rounding or two. For the other types the absolute floor is 1e-6 of
the tensor's largest update in place of 1e-9: their normalised updates
(RMSprop's and Adagrad's first steps are about ``lr / sqrt(1 - decay)``,
10 lr) carry a few roundings of the update into parameters that sit near
zero. Where a normalising rule takes coupled decay (AdamWithClip,
Adagrad) it is 1e-5 of the update: the norm clip's global norm rounds
otherwise than optax's (summed by port tensor, not by JAX leaf), and an
element whose clipped gradient nearly cancels against its decay carries
that rounding through the rule's denominator. With Adafactor's momentum
kept in bf16 it is 1e-2 of the update,
the EMA's bf16 roundings (JAX's jitted step keeps some of its products in
fp32, XLA's excess precision, and rounds others). Adafactor runs with
``min_dim_size_to_factor: 2``, so that the
tiny model's qkv, its patch embedding and its stacked LayerNorms are
factored, and its statistics are per JAX leaf (L layers stacked); LARS's
trust ratio too.

The checkpoint of each rule's state resumes bit for bit, and an Adam
checkpoint in the layout the port wrote before its other rules existed
(``optimizer: {count, sched_count, mu, nu}``) resumes as it did.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
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

from declip_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from declip_tpu_torch.convert import jax_leaves, state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.optim import (
    global_norm,
    group_labels,
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
    state_bytes,
)
from declip_tpu_torch.train import new_train_state

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


def test_jax_leaves_are_the_jax_tree(jax_params):
    """``jax_leaves`` regroups the port's tensors into the JAX tree's
    leaves: the same values in the same layout, leaf for leaf (the
    resblocks stacked, the patch embedding a Dense)."""
    named = dict(_port_model(jax_params).named_parameters())
    leaves = jax_leaves(_port_model(jax_params))
    flat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert len(leaves) == len(flat)
    want = {}
    for path, leaf in flat:
        names = [p.key for p in path]
        key = ".".join(["encode_text" if names[0] == "text" else names[0]]
                       + names[1:])
        want[key] = leaf
    got = {leaf.key: leaf.to_jax([named[n] for n in leaf.names])
           for leaf in leaves}
    by_value = sorted(want.values(), key=lambda a: (a.shape, a.sum()))
    mine = sorted((t.detach().numpy() for t in got.values()),
                  key=lambda a: (a.shape, a.sum()))
    for a, b in zip(by_value, mine):
        np.testing.assert_array_equal(a, b)
    qkv = next(leaf for leaf in leaves
               if leaf.key == "visual.transformer.layers.attn.in_proj_weight")
    assert tuple(got[qkv.key].shape) == (2, 64, 192)
    patch = next(leaf for leaf in leaves if leaf.key == "visual.conv1.weight")
    assert tuple(got[patch.key].shape) == (8 * 8 * 3, 64)
    for leaf in leaves:  # and back, as views of the port's layout
        for n, t in zip(leaf.names, leaf.from_jax(got[leaf.key])):
            assert torch.equal(t, named[n]), n


OPTIMIZERS = {
    # declip88m_vitb32_declip's SGD, at an lr that moves the weights
    "SGD": {"type": "SGD", "kwargs": {"lr": 0.1, "nesterov": True,
                                      "momentum": 0.9, "weight_decay": 0.1}},
    "FP16SGD": {"type": "FP16SGD", "kwargs": {"lr": 0.1,
                                              "weight_decay": 0.1}},
    # yfcc15m_vit_siglip's Adafactor, factoring forced
    "Adafactor": {"type": "Adafactor", "kwargs": {
        "lr": 0.001, "weight_decay": 0.0001, "decay_rate": 0.8,
        "clipping_threshold": 1.0, "min_dim_size_to_factor": 2}},
    "Adafactor-momentum": {"type": "Adafactor", "kwargs": {
        "lr": 0.001, "weight_decay": 0.1, "min_dim_size_to_factor": 2,
        "momentum": 0.9, "clipping_threshold": None,
        "multiply_by_parameter_scale": False}},
    "Adafactor-bf16-momentum": {"type": "Adafactor", "kwargs": {
        "lr": 0.001, "min_dim_size_to_factor": 2, "momentum": 0.9,
        "dtype_momentum": "bfloat16"}},
    "LARS": {"type": "LARS", "kwargs": {"lr": 0.1, "weight_decay": 0.1,
                                        "momentum": 0.9, "nesterov": True}},
    "AdamW_SGD": {"type": "FP16AdamW_SGD", "kwargs": {
        "lr": 1e-3,
        "text_config": {"lr": 2e-3, "weight_decay": 0.1,
                        "betas": [0.9, 0.98]},
        "visual_config": {"lr": 5e-2, "momentum": 0.9,
                          "weight_decay": 0.05}}},
    "AdamWithClip": {"type": "AdamWithClip", "kwargs": {
        "lr": 1e-3, "max_norm": 0.2, "weight_decay": 0.1}},
    "AdamWWithClip": {"type": "AdamWWithClip", "kwargs": {
        "lr": 1e-3, "max_norm": 0.2, "weight_decay": 0.1}},
    "RMSprop": {"type": "FP16RMSprop", "kwargs": {"lr": 1e-3,
                                                  "weight_decay": 0.1}},
    "Adadelta": {"type": "Adadelta", "kwargs": {"lr": 1.0,
                                                "weight_decay": 0.1}},
    "Adagrad": {"type": "Adagrad", "kwargs": {"lr": 1e-2,
                                              "weight_decay": 0.1}},
}
OPT_CLIP = {"type": "norm", "value": 0.5}
# the absolute floor, in units of the tensor's largest update, where it is
# not 1e-6 (see the module docstring)
FLOORS = {"Adafactor-bf16-momentum": 1e-2, "AdamWithClip": 1e-5,
          "Adagrad": 1e-5}


def _sched(ocfg):
    """Warmup to the optimizer's lr from a tenth of it (the JAX package
    reads the lr from the schedule alone)."""
    lr = float(ocfg["kwargs"]["lr"])
    return {"type": "Cosine", "kwargs": {
        "base_lr": lr / 10, "warmup_lr": lr, "warmup_steps": 2}}


def _grads(params, seed, n=2):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1, params)
        for _ in range(n)]


def _port_rule(model, ocfg):
    params = dict(model.named_parameters())
    return optim_entry(
        ocfg, model, scheduler_entry(_sched(ocfg), max_iter=10),
        pconfig=PCONFIG, grad_clip=OPT_CLIP,
        frozen_mask=path_prefix_mask(params,
                                     model.visual.frozen_param_paths()))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(jax_params, name):
    """Two updates of each type with the pconfig, the norm clip and the
    frozen conv1, against optax through the JAX package's optim_entry."""
    ocfg = OPTIMIZERS[name]
    grads = _grads(jax_params, len(name))
    tx = jax_optim_entry(
        ocfg, jax_params, jax_scheduler_entry(_sched(ocfg), max_iter=10),
        pconfig=PCONFIG, grad_clip=OPT_CLIP,
        frozen_mask=jax_prefix_mask(jax_params, ("patch_embed",)))

    @jax.jit
    def one_update(params, state, g):
        # one jit a step, as the JAX solver's: the state, bf16 momentum
        # included, is rounded to its dtype between steps
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    params, state = jax_params, tx.init(jax_params)
    for g in grads:
        params, state = one_update(params, state, g)
    want = state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, params)})
    before = state_from_jax_variables({"params": jax_params})
    model = _port_model(jax_params)
    params = dict(model.named_parameters())
    rule = _port_rule(model, ocfg)
    state = rule.init(params)
    for g in grads:
        rule.update_(state_from_jax_variables({"params": g}), state, params)
    assert (state.count, state.sched_count) == (2, 2)
    assert torch.equal(params["visual.conv1.weight"],
                       before["visual.conv1.weight"])
    for n, p in params.items():
        moved = float((want[n] - before[n]).abs().max())
        floor = FLOORS.get(name, 1e-6)
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=max(1e-9, floor * moved),
                                   err_msg=n)
    if name == "Adafactor":  # factored: a row and a column per matrix
        leaves = state.slots["v_row"]
        assert "visual.conv1.weight" in leaves
        assert tuple(leaves[
            "visual.transformer.layers.attn.in_proj_weight"].shape) == (2, 64)
        assert state_bytes(state) < 0.2 * sum(
            4 * p.numel() for p in params.values())


def test_unknown_optimizer_raises_keyerror(jax_params):
    with pytest.raises(KeyError, match="unknown optimizer type"):
        optim_entry({"type": "Lion", "kwargs": {"lr": 0.1}},
                    _port_model(jax_params), lambda step: 0.1)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_checkpoint_resumes_every_rule_bit_for_bit(tmp_path, jax_params,
                                                   name):
    """After one update, a save and a restore into a fresh state give the
    same slots, counts and parameters bit for bit, and the next update
    lands where the uninterrupted run's does."""
    grads = [state_from_jax_variables({"params": g})
             for g in _grads(jax_params, 3)]

    def fresh():
        model = _port_model(jax_params)
        rule = _port_rule(model, OPTIMIZERS[name])
        params = dict(model.named_parameters())
        return model, rule, new_train_state(model=model,
                                            opt_state=rule.init(params))

    model, rule, state = fresh()
    params = dict(model.named_parameters())
    rule.update_(grads[0], state.opt_state, params)
    state.step = 1
    path = save_checkpoint(str(tmp_path), state)
    model2, rule2, state2 = fresh()
    restore_checkpoint(path, state2)
    a, b = state.opt_state, state2.opt_state
    assert (a.count, a.sched_count) == (b.count, b.sched_count) == (1, 1)
    assert sorted(a.slots) == sorted(b.slots)
    for slot in a.slots:
        for k, t in a.slots[slot].items():
            assert t.dtype == b.slots[slot][k].dtype
            assert torch.equal(t, b.slots[slot][k]), (slot, k)
    params2 = dict(model2.named_parameters())
    rule.update_(grads[1], a, params)
    rule2.update_(grads[1], b, params2)
    for n, p in params.items():
        assert torch.equal(p, params2[n]), n


def test_adam_checkpoint_of_the_earlier_layout_resumes(tmp_path,
                                                       jax_params):
    """A file as the port wrote it when Adam was its only rule: the
    optimizer entry ``{count, sched_count, mu, nu}``."""
    model = _port_model(jax_params)
    params = dict(model.named_parameters())
    rng = np.random.default_rng(5)
    mu = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
          for n, p in params.items()}
    nu = {n: torch.from_numpy(rng.random(size=p.shape).astype(np.float32))
          for n, p in params.items()}
    path = str(tmp_path / "ckpt_7.pth.tar")
    torch.save({"model": {k: v.detach().clone()
                          for k, v in model.state_dict().items()},
                "last_iter": 7,
                "optimizer": {"count": 7, "sched_count": 5, "mu": mu,
                              "nu": nu},
                "ema": None, "logit_guard": None, "bank": None}, path)
    rule = _port_rule(model, {"type": "AdamW", "kwargs": {"lr": 1e-3}})
    state = new_train_state(model=model, opt_state=rule.init(params))
    restore_checkpoint(path, state)
    assert (state.step, state.opt_state.count,
            state.opt_state.sched_count) == (7, 7, 5)
    for n in params:
        assert torch.equal(state.opt_state.mu[n], mu[n])
        assert torch.equal(state.opt_state.nu[n], nu[n])
    sgd = _port_rule(model, OPTIMIZERS["SGD"])
    other = new_train_state(model=model, opt_state=sgd.init(params))
    with pytest.raises(ValueError, match="slots"):
        restore_checkpoint(path, other)


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
