"""The port's MoE towers (declip_tpu_torch.models.layers.MoeMlpBlock, the
towers' ``moe`` knobs, the aux loss in the train step) against the JAX
package's, on seeded numpy inputs with JAX's weights carried across
(``state_from_jax_variables``):

- the block's output, aux loss and gradients (input and every parameter)
  in fp32 within 1e-5, for one expert (which must also equal
  ``MlpBlock``), a capacity that drops most tokens, and top-2 whose
  second pass overflows;
- a 3-step trajectory of a tiny MoE CLIP (both towers MoE, a capacity
  that drops tokens) and of DeCLIP ViT-B/32 with a MoE text tower (its
  ``fuse_views`` on: a MoE tower must still run the two caption batches
  apart), at the trajectory tests' tolerances (tests/test_torch_train.py,
  tests/test_torch_declip.py), ``moe_aux_loss`` included;
- Adafactor on the MoE leaves ([L, E, ...], ``convert.jax_leaves``)
  against optax;
- the served model (``load_eval_model``) in eval mode on a batch padded
  as the serving batcher pads it: JAX's features, and no aux loss;
- the kept refusals (GradCache with MoE; ``pp``, which raises naming
  ROADMAP item 1.10) and a ResNet tower with ``moe`` raising.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_declip as tdeclip
import test_torch_defilip as tdefilip
import test_torch_train as ttrain
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.models.layers import MlpBlock as JaxMlpBlock
from declip_tpu.models.layers import MoeMlpBlock as JaxMoeMlpBlock
from declip_tpu.models.memory_bank import init_bank as jax_init_bank
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry

from declip_tpu_torch.config import parse_config
from declip_tpu_torch.convert import (
    bank_from_jax,
    jax_leaves,
    state_from_jax_variables,
)
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.layers import (
    MlpBlock,
    MoeMlpBlock,
    pop_moe_aux,
)
from declip_tpu_torch.optim import (
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
)
from declip_tpu_torch.train import (
    EmaConfig,
    init_ema,
    make_train_step,
    new_train_state,
)

BLOCK_TOL = 1e-5
STEPS = 3
# name: (experts, top_k, capacity_factor, batch, tokens)
BLOCKS = {"single_expert": (1, 1, 1.0, 2, 5),
          "drops_most": (4, 1, 0.25, 4, 10),
          "top2_overflow": (4, 2, 0.75, 4, 10)}
MOE = {"num_experts": 4, "top_k": 2, "capacity_factor": 0.6,
       "aux_weight": 0.05}


def _moe_clip_cfg():
    """tests/test_torch_train.py's tiny CLIP with both towers MoE: 4
    experts, top-2, a capacity of 0.6 that drops tokens."""
    cfg = ttrain._model_cfg()
    kwargs = dict(cfg["kwargs"])
    for tower in ("image_encode", "text_encode"):
        kwargs[tower] = {**kwargs[tower], "moe": dict(MOE)}
    return {"type": cfg["type"], "kwargs": kwargs}


def _moe_declip_cfg():
    """tests/test_torch_declip.py's declip_vitb32 with a MoE text tower
    and ``fuse_views`` on."""
    cfg, res = tdeclip.MODELS["vitb32"]
    kwargs = dict(cfg["kwargs"])
    kwargs["text_encode"] = {**kwargs["text_encode"], "moe": dict(MOE)}
    kwargs["clip"] = {**kwargs["clip"], "fuse_views": True}
    return {"type": cfg["type"], "kwargs": kwargs}, res


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------------- block
def _block_case(name):
    e, k, cf, b, t = BLOCKS[name]
    d = 16
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    probe = (rng.normal(size=(b, t, d))).astype(np.float32)
    jm = JaxMoeMlpBlock(num_experts=e, top_k=k, capacity_factor=cf)
    h = 4 * d
    params = {name: (rng.normal(size=shape) * std).astype(np.float32)
              for name, shape, std in (
                  ("router", (d, e), d ** -0.5), ("wi", (e, d, h), 0.2),
                  ("bi", (e, h), 0.1), ("wo", (e, h, d), 0.1),
                  ("bo", (e, d), 0.1))}

    def loss(p, x):
        y, aux = jm.apply({"params": p}, x)
        return jnp.sum(y * probe) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (e, k, cf, x, probe, params,
            jax.tree_util.tree_map(np.asarray, (y, aux, grads)))


def _port_block(e, k, cf, params, d=16):
    block = MoeMlpBlock(d, e, k, cf)
    with torch.no_grad():
        for n in ("router", "wi", "bi", "wo", "bo"):
            getattr(block, n).copy_(torch.from_numpy(np.array(params[n])))
    return block.train()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    e, k, cf, x, probe, params, (y, aux, (gp, gx)) = _block_case(name)
    block = _port_block(e, k, cf, params)
    xt = torch.from_numpy(x).requires_grad_()
    yt, auxt = block(xt)
    ((yt * torch.from_numpy(probe)).sum() + auxt).backward()
    tol = dict(rtol=BLOCK_TOL, atol=BLOCK_TOL)
    np.testing.assert_allclose(_np(yt), y, **tol, err_msg="y")
    np.testing.assert_allclose(float(auxt.detach()), float(aux), **tol)
    np.testing.assert_allclose(_np(xt.grad), gx, **tol, err_msg="dx")
    for n in ("router", "wi", "bi", "wo", "bo"):
        np.testing.assert_allclose(_np(getattr(block, n).grad), gp[n],
                                   **tol, err_msg=f"d{n}")
    n_tok = x.shape[0] * x.shape[1]
    kept = block.kept.tolist()
    if name == "single_expert":
        assert kept == [n_tok]
        # one expert, gate 1: the dense MLP with the same weights
        mlp = MlpBlock(x.shape[-1])
        with torch.no_grad():
            mlp.c_fc.weight.copy_(block.wi[0].t())
            mlp.c_fc.bias.copy_(block.bi[0])
            mlp.c_proj.weight.copy_(block.wo[0].t())
            mlp.c_proj.bias.copy_(block.bo[0])
            np.testing.assert_allclose(_np(mlp(torch.from_numpy(x))),
                                       _np(yt), **tol)
        jd = JaxMlpBlock()
        dense = jd.apply({"params": {
            "c_fc": {"kernel": params["wi"][0], "bias": params["bi"][0]},
            "c_proj": {"kernel": params["wo"][0],
                       "bias": params["bo"][0]}}}, jnp.asarray(x))
        np.testing.assert_allclose(_np(yt), np.asarray(dense), **tol)
    elif name == "drops_most":
        assert kept[0] < n_tok / 2, kept
    else:  # the first pass fits, the second overflows
        assert kept[0] == n_tok and kept[1] < n_tok, kept


# ------------------------------------------------------------- trajectory
GRAD_CLIP = {"type": "norm", "value": 1.0}


@functools.lru_cache(maxsize=None)
def jax_moe_clip():
    """(config, JAX module, numpy params) of the MoE CLIP, its weights the
    port's seeded init carried to JAX by the JAX package's converter."""
    cfg = _moe_clip_cfg()
    params = tdefilip._seeded_variables(cfg)["params"]
    return cfg, jax_model_entry(cfg), params


@functools.lru_cache(maxsize=None)
def jax_moe_clip_run():
    """JAX's STEPS-step trajectory of the MoE CLIP on
    ``ttrain._batch()`` with AdamW and the norm clip: (state, history),
    once a process (tests/test_torch_fsdp_ep.py holds its world-2 cases
    to it)."""
    _, jmodel, params = jax_moe_clip()
    return ttrain._run_jax(jmodel, params, GRAD_CLIP, None, STEPS,
                           ttrain._batch())


@pytest.fixture(scope="module")
def clip_init():
    return jax_moe_clip()


def test_moe_clip_trajectory_matches_jax(clip_init):
    cfg, jmodel, params = clip_init
    grad_clip = GRAD_CLIP
    batch = ttrain._batch()
    jstate, jhist = jax_moe_clip_run()
    port = model_entry(cfg)
    port.load_state_dict(state_from_jax_variables({"params": params}),
                         strict=True)
    named = dict(port.named_parameters())
    sched = scheduler_entry(ttrain.SCHED, max_iter=ttrain.MAX_ITER)
    tx = optim_entry(ttrain.OPT, port, sched, pconfig=ttrain.PCONFIG,
                     grad_clip=grad_clip, frozen_mask=path_prefix_mask(
                         named, port.visual.frozen_param_paths()))
    state = new_train_state(model=port, opt_state=tx.init(named))
    step = make_train_step(port, tx, {"grad_clip": grad_clip}, sched)
    start = {n: _np(p).copy() for n, p in named.items()}
    tbatch = ttrain._torch_batch(batch)
    for i in range(STEPS):
        state, metrics = step(state, tbatch)
        for key in ("loss", "grad_norm", "moe_aux_loss"):
            np.testing.assert_allclose(
                float(metrics[key]), jhist[i][key], rtol=ttrain.RTOL,
                err_msg=f"step {i} {key}")
        for key in ("clip_loss", "top1", "logit_scale", "lr"):
            np.testing.assert_allclose(
                float(metrics[key]), jhist[i][key], rtol=ttrain.RTOL,
                atol=ttrain.ATOL, err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == 0.0
        assert float(metrics["moe_aux_loss"]) > 0
    kept = [m.kept.tolist() for m in port.modules()
            if isinstance(m, MoeMlpBlock)]
    assert any(sum(k) < 2 * 616 for k in kept[2:]), kept  # text drops
    lr_sum = sum(h["lr"] for h in jhist)
    final = state_from_jax_variables({"params": jstate.params})
    ttrain._assert_params_close(
        {n: _np(p) for n, p in state.params.items()},
        {n: t.numpy() for n, t in final.items()}, start, lr_sum, "params")


def test_moe_declip_trajectory_matches_jax(monkeypatch):
    cfg, res = _moe_declip_cfg()
    jmodel = jax_model_entry(cfg)
    batch = tdeclip._batch(res)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda: jmodel.init(jax.random.PRNGKey(0), batch, train=True))()))
    jbank = jax_init_bank(jax.random.PRNGKey(1), tdeclip.BANK, 64)
    monkeypatch.setattr(tdeclip, "STEPS", STEPS)
    jstate, jhist = tdeclip._run_jax("vitb32", jmodel, variables, jbank,
                                     batch)
    grad_clip, ema = tdeclip.GUARDS["vitb32"]
    port = model_entry(cfg)
    port.load_state_dict(state_from_jax_variables(variables), strict=True)
    port.train()
    named = dict(port.named_parameters())
    sched = scheduler_entry(tdeclip.SCHED, max_iter=tdeclip.MAX_ITER)
    tx = optim_entry(tdeclip.OPT, port, sched, pconfig=tdeclip.PCONFIG,
                     grad_clip=grad_clip, frozen_mask=path_prefix_mask(
                         named, port.visual.frozen_param_paths()))
    ema_cfg = EmaConfig(*ema)
    state = new_train_state(
        model=port, opt_state=tx.init(named),
        ema_params=init_ema(named, ema_cfg), with_logit_guard=True,
        bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    step = make_train_step(port, tx, tdeclip._cfg("vitb32"), sched,
                           ema_cfg=ema_cfg, total_steps=tdeclip.MAX_ITER)
    start = {n: _np(p).copy() for n, p in named.items()}
    tbatch = tdeclip._torch_batch(batch)
    calls = []
    port.encode_text.register_forward_hook(
        lambda m, args, out: calls.append(args[0].shape[0]))
    for i in range(STEPS):
        state, metrics = step(state, tbatch)
        for key in ("loss", "grad_norm", "moe_aux_loss"):
            np.testing.assert_allclose(
                float(metrics[key]), jhist[i][key], rtol=tdeclip.RTOL,
                err_msg=f"step {i} {key}")
        for key in ("clip_loss", "text_mlm_loss", "clip_nn_text_loss"):
            np.testing.assert_allclose(
                float(metrics[key]), jhist[i][key], rtol=tdeclip.RTOL,
                atol=tdeclip.ATOL, err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == 0.0
    # two caption batches of B a step, never one fused batch of 2B
    assert calls == [tdeclip.B] * (2 * STEPS)
    lr_sum = sum(h["lr"] for h in jhist)
    final = {n: t.numpy() for n, t in state_from_jax_variables(
        {"params": jstate.params}).items()}
    got = {n: _np(p) for n, p in state.params.items()}
    tdeclip._assert_close(got, final, start, lr_sum, "params")
    np.testing.assert_allclose(state.bank_text.bank.numpy(),
                               np.asarray(jstate.bank_text.bank),
                               rtol=tdeclip.RTOL, atol=1e-5)


# ---------------------------------------------------------------- adafactor
def test_adafactor_on_moe_leaves_matches_optax(clip_init):
    """Two Adafactor updates (the SigLIP recipe's, factoring forced) of
    the MoE CLIP, the experts' [L, E, d, h] leaves factored over their
    two largest axes, against optax."""
    cfg, _, params = clip_init
    ocfg = {"type": "Adafactor", "kwargs": {
        "lr": 0.001, "weight_decay": 0.0001, "decay_rate": 0.8,
        "clipping_threshold": 1.0, "min_dim_size_to_factor": 2}}
    sched = {"type": "Cosine", "kwargs": {"base_lr": 1e-4,
                                          "warmup_lr": 1e-3,
                                          "warmup_steps": 2}}
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1, params)
        for _ in range(2)]
    tx = jax_optim_entry(ocfg, params,
                         jax_scheduler_entry(sched, max_iter=10))
    jp, js = params, tx.init(params)
    for g in grads:
        updates, js = jax.jit(tx.update)(g, js, jp)
        jp = optax.apply_updates(jp, updates)
    want = state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jp)})
    before = state_from_jax_variables({"params": params})

    port = model_entry(cfg)
    port.load_state_dict(before, strict=True)
    named = dict(port.named_parameters())
    rule = optim_entry(ocfg, port, scheduler_entry(sched, max_iter=10))
    state = rule.init(named)
    leaf = "visual.transformer.layers.moe.wi"
    assert [lf.key for lf in jax_leaves(port)].count(leaf) == 1
    # [L, E, d, h] = [2, 4, 64, 256]: a row [2, 4, 64], a column [2, 4, 256]
    assert tuple(state.slots["v_row"][leaf].shape) == (2, 4, 64)
    assert tuple(state.slots["v_col"][leaf].shape) == (2, 4, 256)
    for g in grads:
        rule.update_(state_from_jax_variables({"params": g}), state, named)
    for n, p in named.items():
        moved = float((want[n] - before[n]).abs().max())
        np.testing.assert_allclose(_np(p), want[n].numpy(), rtol=1e-6,
                                   atol=max(1e-9, 1e-6 * moved), err_msg=n)


# --------------------------------------------------------------------- eval
def test_eval_forward_matches_jax_without_aux(clip_init, tmp_path):
    """The served model (``load_eval_model``, seeded as ``clip_init``'s
    weights were) in eval mode on a batch padded as the serving batcher
    pads it (zero rows, which enter the capacity in both packages)."""
    from declip_tpu_torch.tools._common import load_eval_model

    cfg, jmodel, params = clip_init
    batch = ttrain._batch(1)
    for k, v in batch.items():
        v[6:] = 0
    want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b,
                                             train=False))(params, batch)
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(json.dumps({"model": cfg}))
    port = load_eval_model(str(cfg_path), device="cpu")
    assert not port.training
    with torch.no_grad():
        out = port(ttrain._torch_batch(batch))
    for key in ("image_embed", "text_embed"):
        np.testing.assert_allclose(_np(out[key]), np.asarray(want[key]),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL,
                                   err_msg=key)
    assert pop_moe_aux(port) is None


# ------------------------------------------------------------------ refusals
def test_moe_configs_build_and_refusals_stay():
    # the moe dict expands into the towers' knobs (the raise is gone)
    port = model_entry(_moe_clip_cfg())
    blocks = [m for m in port.modules() if isinstance(m, MoeMlpBlock)]
    assert len(blocks) == 4 and all(
        (b.num_experts, b.top_k, b.capacity_factor) == (4, 2, 0.6)
        for b in blocks)
    assert port.visual.transformer.moe_aux_weight == 0.05
    sched = scheduler_entry(ttrain.SCHED, max_iter=10)
    tx = optim_entry(ttrain.OPT, port, sched)
    with pytest.raises(NotImplementedError, match="grad_cache \\+ MoE"):
        make_train_step(port, tx, {"grad_cache": {"chunks": 2}}, sched)
    res = {"type": "clip_res50", "kwargs": {
        "image_encode": {"embed_dim": 32, "layers": (1, 1, 1, 1),
                         "width": 8, "heads": 2, "input_resolution": 64,
                         "moe": {"num_experts": 2}},
        "text_encode": {"embed_dim": 32, "transformer_width": 32,
                        "transformer_heads": 2, "transformer_layers": 1,
                        "vocab_size": 100}}}
    with pytest.raises(TypeError, match="moe_experts"):
        model_entry(res)


@pytest.mark.parametrize("pcfg,match", [
    ({"pp": 2}, "pp"), ({"tp": 2}, "tp"), ({"sp": True}, "sp"),
    ({"slices": 2}, "slices"), ({"ep": 2, "fsdp": True}, "ep, fsdp")])
def test_unported_parallelism_raises(pcfg, match):
    from declip_tpu_torch.solver import Solver

    cfg = parse_config("x: 0")
    cfg["parallelism"] = pcfg
    with pytest.raises(NotImplementedError, match=f"{match}.*1.10"):
        Solver(cfg, device="cpu")
