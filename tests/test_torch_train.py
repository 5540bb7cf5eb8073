"""The port's CLIP training step (declip_tpu_torch.train) against the JAX
package's ``make_train_step``, on a tiny CLIP ViT-B/32 (2 layers, width 64).

Both sides start from the JAX init (weights cross over through
``state_from_jax_variables``), take the same numpy batch four times with the
YFCC15M recipe's AdamW (betas 0.9/0.98, wd 0.1, zero decay for ln/bias/
logit_scale, frozen conv1) on a warmup-cosine schedule, and are compared
step by step. The port's attention is its default: on CPU tensors the plain
forward and ``attention_bwd_plain`` through the autograd Function; the JAX
side takes its default (XLA) attention on CPU.

Tolerances: fp32 loss and grad_norm rtol 1e-4, final params and EMA
rtol/atol 1e-4 (two layers of matmuls, LayerNorms and softmaxes summed in
other orders, then four Adam steps that divide by the root of the second
moment); bf16 losses rtol/atol 2e-2 (activations rounded to bf16 at other
places by XLA and by torch).

One slice is held otherwise: the key rows of each ``in_proj_bias``. They add
one constant to every score of a query's row, which the softmax removes, so
their gradient is 0 in exact arithmetic; each package computes rounding
noise there (about 1e-8 against 1e-2..1 on the query and value rows), and
Adam (eps 1e-8) scales that noise into steps of up to the lr, in directions
that differ between the packages. Those rows are held to Adam's step bound
instead (|step| <= lr while 1 - b1 < sqrt(1 - b2), Kingma & Ba 2015, 2.1),
and their gradient to the noise level.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.config import parse_config as jax_parse_config
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry
from declip_tpu.optim.param_groups import path_prefix_mask as jax_prefix_mask
from declip_tpu.train import EmaConfig as JaxEmaConfig
from declip_tpu.train import init_ema as jax_init_ema
from declip_tpu.train import make_train_step as jax_make_train_step
from declip_tpu.train import new_train_state as jax_new_train_state

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)
from declip_tpu_torch.optim import (
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
)
from declip_tpu_torch.train import (
    EmaConfig,
    init_ema,
    make_loss_fn,
    make_train_step,
    new_train_state,
)

RES, VOCAB, B, STEPS = 32, 100, 8, 4
RTOL = ATOL = 1e-4


def _model_cfg(dtype="float32"):
    return {"type": "clip_vitb32", "kwargs": {
        "image_encode": {"embed_dim": 32, "input_resolution": RES,
                         "patch_size": 8, "width": 64, "layers": 2,
                         "heads": 2},
        "text_encode": {"embed_dim": 32, "transformer_width": 64,
                        "transformer_heads": 2, "transformer_layers": 2,
                        "vocab_size": VOCAB},
        "clip": {"use_allgather": True},
        "dtype": dtype,
    }}


OPT = {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.1,
                                   "betas": [0.9, 0.98], "eps": 1e-8}}
PCONFIG = {g: {"weight_decay": 0} for g in
           ("bn_w", "bn_b", "ln_w", "ln_b", "linear_b", "conv_b",
            "logit_scale")}
SCHED = {"type": "Cosine", "kwargs": {"base_lr": 1e-4, "warmup_lr": 1e-3,
                                      "min_lr": 0.0, "warmup_steps": 2}}
MAX_ITER = 10

# EMA (decay, warmup, inner_T, copy_init): the warmup ramp
# min(decay, (1+t)/(2+t)) moves the shadow within four steps
EMA = (0.999, 2, 1, False)
CASES = {  # grad_clip, EMA or None
    "logit_scale_param_value": ({"type": "logit_scale_param_value",
                                 "value": 3, "max_value": 6}, None),
    "norm": ({"type": "norm", "value": 1.0}, None),
    "logit_scale_param_ema": ({"type": "logit_scale_param_ema",
                               "value": 0.2}, None),
    "constant": ({"type": "constant", "value": 0}, None),
    "logit_scale_param": ({"type": "logit_scale_param", "value": 2e-4},
                          None),
    "logit_scale_param_abs_min": ({"type": "logit_scale_param_abs_min",
                                   "value": 3.0}, None),
    "ema": ({"type": "logit_scale_param_value", "value": 3,
             "max_value": 6}, EMA),
    "ema-strided-copy": ({"type": "norm", "value": 1.0},
                         (0.9, 1, 2, True)),
}


def _key_rows(name, arr):
    """The key rows of an in_proj_bias (rows q, k, v), else None."""
    if not name.endswith("attn.in_proj_bias"):
        return None
    width = arr.shape[0] // 3
    return slice(width, 2 * width)


def _assert_params_close(got, want, start, lr_sum, what):
    """got/want/start: {port name: numpy array}. Key rows of in_proj_bias:
    each side within lr_sum of its start (see the module docstring)."""
    for name, g in got.items():
        w = want[name]
        rows = _key_rows(name, g)
        if rows is not None:
            for side in (g, w):
                assert np.abs(side[rows] - start[name][rows]).max() <= \
                    lr_sum * 1.001, (what, name)
            g, w = np.delete(g, rows), np.delete(w, rows)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(B, RES, RES, 3)).astype(np.float32),
            "tokens": rng.integers(1, VOCAB, (B, 77)).astype(np.int32)}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "tokens": torch.from_numpy(batch["tokens"]).long()}


@pytest.fixture(scope="module")
def jax_init():
    """One JAX init per compute dtype: (model, numpy params)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = jax_model_entry(_model_cfg(dtype))
        b = _batch()
        variables = jax.jit(
            lambda: model.init(jax.random.PRNGKey(0), b, train=True))()
        out[dtype] = (model, jax.tree_util.tree_map(np.asarray,
                                                    variables["params"]))
    return out


def _run_jax(model, params, grad_clip, ema, steps, batch):
    cfg = jax_parse_config("x: 0")
    cfg["grad_clip"] = grad_clip
    sched = jax_scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = jax_optim_entry(
        OPT, params, sched, pconfig=PCONFIG, grad_clip=grad_clip,
        frozen_mask=jax_prefix_mask(params, ("patch_embed",)))
    ema_cfg = JaxEmaConfig(*ema) if ema else None
    state = jax_new_train_state(
        params=params, batch_stats={}, opt_state=tx.init(params),
        ema_params=jax_init_ema(params, ema_cfg) if ema else None,
        with_logit_guard=grad_clip["type"] == "logit_scale_param_ema")
    step = jax.jit(jax_make_train_step(model, tx, cfg, sched,
                                       ema_cfg=ema_cfg))
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return jax.device_get(state), history


def _port_setup(params, grad_clip, ema, dtype="float32"):
    model = model_entry(_model_cfg(dtype))
    model.load_state_dict(state_from_jax_variables({"params": params}),
                          strict=True)
    named = dict(model.named_parameters())
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(
        OPT, model, sched, pconfig=PCONFIG, grad_clip=grad_clip,
        frozen_mask=path_prefix_mask(named,
                                     model.visual.frozen_param_paths()))
    ema_cfg = EmaConfig(*ema) if ema else None
    state = new_train_state(
        model=model, opt_state=tx.init(named),
        ema_params=init_ema(named, ema_cfg) if ema else None,
        with_logit_guard=grad_clip["type"] == "logit_scale_param_ema")
    step = make_train_step(model, tx, {"grad_clip": grad_clip}, sched,
                           ema_cfg=ema_cfg)
    return state, step


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(jax_init, case):
    grad_clip, ema = CASES[case]
    model, params = jax_init["float32"]
    batch = _batch()
    jstate, jhist = _run_jax(model, params, grad_clip, ema, STEPS, batch)

    state, step = _port_setup(params, grad_clip, ema)
    start = {n: p.detach().numpy().copy() for n, p in state.params.items()}
    tbatch = _torch_batch(batch)
    for i in range(STEPS):
        state, metrics = step(state, tbatch)
        want = jhist[i]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, err_msg=f"step {i} {key}")
        for key in ("clip_loss", "top1", "top5", "logit_scale", "lr"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == want["update_skipped"] == 0.0
        if "logit_clip_count" in want:
            assert int(metrics["logit_clip_count"]) == \
                int(want["logit_clip_count"])
    assert state.step == int(jstate.step) == STEPS

    lr_sum = sum(h["lr"] for h in jhist)
    final = state_from_jax_variables({"params": jstate.params})
    _assert_params_close(
        {n: p.detach().numpy() for n, p in state.params.items()},
        {n: t.numpy() for n, t in final.items()}, start, lr_sum, "params")
    if ema:
        # the shadow is a convex mix of its start (zero, or the params) and
        # the params, and the key rows start at zero: the same bound
        shadow = state_from_jax_variables({"params": jstate.ema_params})
        _assert_params_close(
            {n: e.numpy() for n, e in state.ema_params.items()},
            {n: t.numpy() for n, t in shadow.items()},
            {n: np.zeros_like(a) for n, a in start.items()}, lr_sum, "ema")
    if jstate.logit_ema_buffer is not None:
        np.testing.assert_allclose(float(state.logit_ema_buffer),
                                   float(jstate.logit_ema_buffer),
                                   rtol=RTOL)


def test_loss_fn_gradients_match_jax(jax_init):
    """loss_fn's gradient (the port's jax.value_and_grad) equals the JAX
    loss's gradient, parameter by parameter, before any update."""
    model, params = jax_init["float32"]
    batch = _batch(3)

    def jax_loss(p):
        out = model.apply({"params": p}, batch, train=True)
        from declip_tpu.train.method_losses import clip_losses

        return clip_losses(out, {}, None)[0]

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})

    state, _ = _port_setup(params, {"type": "norm", "value": 1.0}, None)
    named = state.params
    total, _ = make_loss_fn({})(state.model, state, _torch_batch(batch))
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=RTOL)
    grads = torch.autograd.grad(total, list(named.values()))
    norm = float(torch.sqrt(sum(g.square().sum() for g in grads)))
    for name, g in zip(named, grads):
        g, w = g.numpy(), want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=name)
        rows = _key_rows(name, g)
        if rows is not None:  # 0 in exact arithmetic: noise on both sides
            assert np.abs(g[rows]).max() < 1e-6 * norm, name
            assert np.abs(w[rows]).max() < 1e-6 * norm, name


def test_nonfinite_step_is_contained(jax_init):
    """A NaN batch leaves params, optimizer state, EMA and the guard's
    buffers bit-identical and reports update_skipped == 1; the next finite
    step proceeds."""
    _, params = jax_init["float32"]
    grad_clip = {"type": "logit_scale_param_ema", "value": 0.2}
    state, step = _port_setup(params, grad_clip, EMA)
    batch = _torch_batch(_batch())
    state, metrics = step(state, batch)  # one good step
    assert metrics["update_skipped"] == 0.0

    def snapshot():
        return {"params": {n: p.detach().clone()
                           for n, p in state.params.items()},
                "mu": {n: t.clone() for n, t in state.opt_state.mu.items()},
                "nu": {n: t.clone() for n, t in state.opt_state.nu.items()},
                "count": state.opt_state.count,
                "ema": {n: t.clone() for n, t in state.ema_params.items()},
                "buffer": state.logit_ema_buffer.clone(),
                "clips": state.logit_clip_count.clone()}

    before = snapshot()
    poison = dict(batch)
    poison["images"] = batch["images"].clone()
    poison["images"][0, 0, 0, 0] = float("nan")
    state, metrics = step(state, poison)
    assert metrics["update_skipped"] == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    assert state.step == 2  # the host counter stays valid
    after = snapshot()
    assert after["count"] == before["count"]
    for key in ("params", "mu", "nu", "ema"):
        for name, t in before[key].items():
            assert torch.equal(t, after[key][name]), (key, name)
    assert torch.equal(before["buffer"], after["buffer"])
    assert torch.equal(before["clips"], after["clips"])

    state, metrics = step(state, batch)
    assert metrics["update_skipped"] == 0.0
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(p, before["params"][n])
               for n, p in state.params.items())


def test_bf16_losses_match_jax(jax_init):
    """The bf16 compute dtype (params and optimizer state fp32): the first
    two losses within 2e-2 of the JAX bf16 model's."""
    grad_clip, _ = CASES["logit_scale_param_value"]
    model, params = jax_init["bfloat16"]
    batch = _batch()
    _, jhist = _run_jax(model, params, grad_clip, None, 2, batch)

    state, step = _port_setup(params, grad_clip, None, dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in state.params.values())
    tbatch = _torch_batch(batch)
    out = state.model(tbatch)
    assert out["image_embed"].dtype == torch.bfloat16
    assert out["logit_scale"].dtype == torch.float32
    before = flash_attention.launches, flash_attention_bwd.launches
    for i in range(2):
        state, metrics = step(state, tbatch)
        np.testing.assert_allclose(float(metrics["loss"]), jhist[i]["loss"],
                                   rtol=2e-2, atol=2e-2)
    assert (flash_attention.launches,
            flash_attention_bwd.launches) == before  # CPU: no kernel
    assert all(t.dtype == torch.float32
               for t in state.opt_state.mu.values())


def test_logit_bias_model_trains_with_the_sigmoid_loss():
    """The tiny CLIP with a SigLIP logit bias (logit_bias_init -10) under
    ``loss_impl: sigmoid_ring`` and the norm clip: the port's step, from
    the JAX init, against JAX's loss and gradient on the same batch (its
    ring over a one-device mesh, as its Solver runs it): the loss, the
    logged bias and the gradient's norm, and each parameter's gradient as
    test_loss_fn_gradients_match_jax holds it; the step moves the bias."""
    from jax.sharding import Mesh

    from declip_tpu.ops.contrastive import make_pair_loss as jax_pair_loss
    from declip_tpu.train.method_losses import clip_losses

    cfg = _model_cfg()
    cfg["kwargs"]["clip"] = {"logit_bias_init": -10.0}
    loss_cfg = {"grad_clip": {"type": "norm", "value": 1.0},
                "loss_impl": {"type": "sigmoid_ring"}}
    jmodel = jax_model_entry(cfg)
    batch = _batch(3)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jmodel.init(jax.random.PRNGKey(0), batch,
                            train=True))()["params"])
    pair = jax_pair_loss(loss_cfg, mesh=Mesh(np.asarray(jax.devices()[:1]),
                                             ("data",)))

    def jax_loss(p):
        out = jmodel.apply({"params": p}, batch, train=True)
        return clip_losses(out, loss_cfg, None, pair)[0]

    loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})

    model = model_entry(cfg)
    model.load_state_dict(state_from_jax_variables({"params": params}),
                          strict=True)
    named = dict(model.named_parameters())
    total, _ = make_loss_fn(loss_cfg)(model, None, _torch_batch(batch))
    np.testing.assert_allclose(float(total.detach()), float(loss), rtol=RTOL)
    got = torch.autograd.grad(total, list(named.values()))
    norm = float(torch.sqrt(sum(g.square().sum() for g in got)))
    for name, g in zip(named, got):
        g, w = g.numpy(), want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=name)
        rows = _key_rows(name, g)
        if rows is not None:  # 0 in exact arithmetic: noise on both sides
            assert np.abs(g[rows]).max() < 1e-6 * norm, name
            assert np.abs(w[rows]).max() < 1e-6 * norm, name
    assert float(np.abs(want["logit_bias"].numpy()).max()) > 0

    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, model, sched, pconfig=PCONFIG,
                     grad_clip=loss_cfg["grad_clip"],
                     frozen_mask=path_prefix_mask(
                         named, model.visual.frozen_param_paths()))
    state = new_train_state(model=model, opt_state=tx.init(named))
    state, metrics = make_train_step(model, tx, loss_cfg, sched)(
        state, _torch_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=RTOL)
    assert float(metrics["logit_bias"]) == -10.0  # what the forward read
    assert float(named["logit_bias"].detach()[0]) != -10.0
