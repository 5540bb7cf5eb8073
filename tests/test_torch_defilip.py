"""The port's DeFILIP (declip_tpu_torch.models.defilip_model), its loss and
its training step against the JAX package's, the weights carried over by
``state_from_jax_variables`` (params and batch_stats) and the bank by
``bank_from_jax``. Both start from the port's seeded init, which the JAX
package's own ``torch_state_to_variables`` turns into the JAX model's
variables (sparing a JAX init's compile):

- ``defilip_vitb32`` at 64 px (16 patch tokens), width 64, 2 layers, a
  64-wide 2-layer text tower, top_k 4, with every DeCLIP head on (MLM, the
  NN bank, text SimSiam, nn-SimSiam): the feature dict with ``dense_aug``,
  ``select_topk`` and MLM on, and with the three off (the dense text then
  comes from the augmented captions' pass); ``defilip_losses``
  under weight type None and ``convirt`` (which leaves the filip term out
  of the total), and its gradient with respect to the features under
  ``dense_aug``;
- experiments/unit/tiny_defilip's model (224 px, the 512-row bank), loss
  weights, ``logit_scale_param_ema`` guard and EMA, with
  tests/test_torch_declip.py's AdamW and schedule: a 4-step fp32 trajectory
  of ``make_train_step``, and every parameter's gradient at its first step
  (JAX's read from the same compiled step).

Tolerances are tests/test_torch_declip.py's (rtol 1e-4, atol 1e-4 on
parameters; the gradients of parameters that are 0 in exact arithmetic
held to the noise level), and so are its batches: each image view noise
around a colour of its own, so that the two views, and with them each
pairing's top-k selection, differ. The port runs its default late
interaction (on CPU tensors the plain versions of K3-K5), JAX its chunked
XLA path.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_declip import (
    MAX_ITER,
    OPT,
    PCONFIG,
    RTOL,
    SCHED,
    STEPS,
    VOCAB,
    _assert_close,
    _batch,
    _close,
    _flat,
    _jax_nn,
    _noise_slice,
    _torch_batch,
)

from declip_tpu.config import parse_config as jax_parse_config
from declip_tpu.convert_pth import torch_state_to_variables
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.models.memory_bank import BankState as JaxBankState
from declip_tpu.models.memory_bank import init_bank as jax_init_bank
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry
from declip_tpu.optim.param_groups import path_prefix_mask as jax_prefix_mask
from declip_tpu.train import EmaConfig as JaxEmaConfig
from declip_tpu.train import init_ema as jax_init_ema
from declip_tpu.train import make_train_step as jax_make_train_step
from declip_tpu.train import new_train_state as jax_new_train_state
from declip_tpu.train.method_losses import defilip_losses as jax_losses

from declip_tpu_torch.config import parse_config
from declip_tpu_torch.convert import bank_from_jax, state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.defilip_model import DEFILIP
from declip_tpu_torch.ops import filip_late_interaction as fli
from declip_tpu_torch.optim import (
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
)
from declip_tpu_torch.train import (
    EmaConfig,
    init_ema,
    make_losses_from_out,
    make_train_step,
    method_of,
    new_train_state,
)

RES, BANK = 64, 48
MODEL = {"type": "defilip_vitb32", "kwargs": {
    "image_encode": {"embed_dim": 64, "input_resolution": RES,
                     "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_encode": {"embed_dim": 64, "transformer_width": 64,
                    "transformer_heads": 2, "transformer_layers": 2,
                    "vocab_size": VOCAB},
    "clip": {"use_allgather": True, "text_mask_type": "MLM",
             "return_nn_bank": True, "return_simsiam_text": True,
             "return_simsiam_nn_text": True, "return_filip": True,
             "select_topk": True, "top_k": 4, "feature_dim": 64,
             "nn_size": BANK, "EDA": True},
    "dtype": "float32"}}
# the yfcc15m_vit_defilip recipe's weights, with the two optional SimSiam
# terms on
WEIGHTS = {"clip_loss": 0.4, "nn_text": 0.2, "simsiam_loss": 0.2,
           "masking_language": 0.2, "filip": 0.2, "text_simsiam_loss": 0.1,
           "nn_simsiam_loss": 0.1}
CONVIRT = {"type": "convirt", "clip_loss": 0.5, "simsiam_loss": 0.5,
           "filip": 0.2}
# (dense_aug, select_topk, MLM): each flag on, then each off (the text
# branch without MLM takes the dense text from the augmented captions)
VARIANTS = {"aug-topk": (True, True, True),
            "all-no-mlm": (False, False, False)}
TINY = "experiments/unit/tiny_defilip/config.yaml"


def _cfg(weights):
    return {"clip_simsiam_loss_weight": dict(weights),
            "grad_clip": {"type": "logit_scale_param_value", "value": 3,
                          "max_value": 6}}


def _seeded_variables(cfg):
    """A JAX model's variables from the port's seeded init, through the JAX
    package's own converter (which spares a JAX init)."""
    port = model_entry(cfg)
    port.init_weights(torch.Generator().manual_seed(0))
    return torch_state_to_variables(port.state_dict())


def _variant_cfg(name):
    dense_aug, select_topk, mlm = VARIANTS[name]
    return {"type": MODEL["type"],
            "kwargs": {**MODEL["kwargs"], "clip": {
                **MODEL["kwargs"]["clip"], "dense_aug": dense_aug,
                "select_topk": select_topk,
                "text_mask_type": "MLM" if mlm else None}}}


def _tiny(path):
    """An experiments/unit config and its model config in fp32 with the
    tests' vocab: -> (config, model config, its EMA's EmaConfig fields)."""
    cfg = parse_config(path)
    kwargs = {**cfg.model.kwargs, "dtype": "float32",
              "text_encode": {**cfg.model.kwargs.text_encode,
                              "vocab_size": VOCAB}}
    return (cfg, {"type": cfg.model.type, "kwargs": kwargs},
            (float(cfg.ema.kwargs.decay), 1, 1, False))


def _capturing(tx):
    """``tx``, keeping in its state the gradient it was last given: the JAX
    train step's own gradient, out of the step's one compile."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_trajectory(mcfg, loss_cfg, ema, batch, bank=None):
    """JAX's ``make_train_step`` on ``mcfg`` from the port's seeded init,
    STEPS steps on ``batch`` with tests/test_torch_declip.py's AdamW and
    schedule: -> {"variables", "hist" (each step's metrics), "state" (the
    last), "grads" (the first step's gradient)}."""
    jmodel = jax_model_entry(mcfg)
    variables = _seeded_variables(mcfg)
    params = variables["params"]
    sched = jax_scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = _capturing(jax_optim_entry(
        OPT, params, sched, pconfig=PCONFIG,
        grad_clip=dict(loss_cfg["grad_clip"]),
        frozen_mask=jax_prefix_mask(params, ("patch_embed",))))
    jstate = jax_new_train_state(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=jax.jit(tx.init)(params),  # one compile, not one a leaf
        ema_params=jax_init_ema(params, JaxEmaConfig(*ema)),
        bank_text=None if bank is None else JaxBankState(
            jnp.asarray(bank.bank), jnp.asarray(bank.ptr)),
        with_logit_guard=True)
    jcfg = jax_parse_config("x: 0")
    jcfg.update(loss_cfg)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, jcfg, sched,
                                        ema_cfg=JaxEmaConfig(*ema),
                                        total_steps=MAX_ITER))
    hist, grads = [], None
    for _ in range(STEPS):
        jstate, metrics = jstep(jstate, batch)
        hist.append({k: float(v) for k, v in metrics.items()})
        if grads is None:
            grads = jax.device_get(jstate.opt_state[1])
    return {"variables": variables, "hist": hist,
            "state": jax.device_get(jstate), "grads": grads}


def _port_trajectory(mcfg, loss_cfg, ema, variables, tbatch, bank=None):
    """The port's ``make_train_step`` as ``_jax_trajectory`` runs JAX's,
    from the same variables, on ``tbatch`` (torch tensors): -> (model,
    state, each step's metrics, the parameters at the start)."""
    port = model_entry(mcfg)
    port.load_state_dict(state_from_jax_variables(variables), strict=True)
    named = dict(port.named_parameters())
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, port, sched, pconfig=PCONFIG,
                     grad_clip=dict(loss_cfg["grad_clip"]),
                     frozen_mask=path_prefix_mask(
                         named, port.visual.frozen_param_paths()))
    state = new_train_state(
        model=port, opt_state=tx.init(named),
        ema_params=init_ema(named, EmaConfig(*ema)), with_logit_guard=True,
        bank_text=None if bank is None else bank_from_jax(bank.bank,
                                                          bank.ptr))
    step = make_train_step(port, tx, loss_cfg, sched,
                           ema_cfg=EmaConfig(*ema), total_steps=MAX_ITER)
    start = {n: p.detach().numpy().copy() for n, p in named.items()}
    hist = []
    for _ in range(STEPS):
        state, metrics = step(state, tbatch)
        hist.append(metrics)
    return port, state, hist, start


def _tiny_loss_cfg(cfg):
    return {"clip_simsiam_loss_weight": dict(cfg.clip_simsiam_loss_weight),
            "grad_clip": dict(cfg.grad_clip)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side, from the port's seeded init, in two compiles. The
    first: both variants' feature dicts and their losses under WEIGHTS and
    CONVIRT, {variant: (feature dict, [(total, metrics)])}, and under
    "out_grads" the gradient of "aug-topk"'s WEIGHTS loss with respect to
    its feature dict. The second, under "trajectory": tiny_defilip's
    ``_jax_trajectory``, the bank included, whose first gradient the
    gradient test reads. Also the variables, the bank and the batch."""
    jbank = jax_init_bank(jax.random.PRNGKey(1), BANK, 64)
    models, variables = {}, {}
    for name in VARIANTS:
        models[name] = jax_model_entry(_variant_cfg(name))
        variables[name] = _seeded_variables(_variant_cfg(name))
    batch = _batch(RES, 1)

    def losses(jmodel, v, out, weights):
        return jax_losses(out, _cfg(weights), None, step=3, total_steps=8,
                          **_jax_nn(jmodel, v, jbank, out))

    def run(variables):
        res = {}
        for name, jmodel in models.items():
            out, _ = jmodel.apply(variables[name], batch, train=True,
                                  mutable=["batch_stats"])
            res[name] = (out, [losses(jmodel, variables[name], out, w)
                               for w in (WEIGHTS, CONVIRT)])
        res["out_grads"] = jax.grad(
            lambda out: losses(models["aug-topk"], variables["aug-topk"],
                               out, WEIGHTS)[0],
            allow_int=True)(res["aug-topk"][0])
        return res

    res = jax.device_get(jax.jit(run)(variables))
    cfg, mcfg, ema = _tiny(TINY)
    rows = int(mcfg["kwargs"]["clip"]["nn_size"])
    dim = int(mcfg["kwargs"]["clip"]["feature_dim"])
    tbank = jax_init_bank(jax.random.PRNGKey(1), rows, dim)
    tiny_batch = _batch(mcfg["kwargs"]["image_encode"]["input_resolution"])
    res["trajectory"] = {
        **_jax_trajectory(mcfg, _tiny_loss_cfg(cfg), ema, tiny_batch,
                          tbank),
        "bank": tbank, "batch": tiny_batch}
    return {"variables": variables, "bank": jbank, "batch": batch, **res}


def _port(jax_runs, name):
    port = model_entry(_variant_cfg(name))
    port.load_state_dict(state_from_jax_variables(
        jax_runs["variables"][name]), strict=True)
    return port.train()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_losses_match_jax(jax_runs, variant):
    """The feature dict, and ``defilip_losses`` under weight type None and
    ``convirt`` with the bank's neighbours. The pairings' selections
    differ from view 1's (the views differ), so a port that reused one
    selection would fail here."""
    want, jterms = jax_runs[variant]
    port = _port(jax_runs, variant)
    assert isinstance(port, DEFILIP) and method_of(port) == "defilip"
    got = port(_torch_batch(jax_runs["batch"]))
    assert sorted(got) == sorted(want)
    assert got["logit_scale_dense"].shape == ()
    for key in want:
        for sub, w in _flat(want[key], key).items():
            g = _flat(got[key], key)[sub].detach().numpy()
            assert g.shape == np.shape(w), sub
            _close(g, w, sub)
    if VARIANTS[variant][0]:
        assert not torch.equal(got["dense_sel_i2_t"][1],
                               got["dense_text_sel"])

    jbank = jax_runs["bank"]
    state = new_train_state(model=port, opt_state=None, step=3,
                            bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    for weights, (jtotal, jmetrics) in zip((WEIGHTS, CONVIRT), jterms):
        total, metrics = make_losses_from_out(
            _cfg(weights), "defilip", total_steps=8)(port, state, got)
        assert sorted(metrics) == sorted(jmetrics)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=RTOL, err_msg=str(weights))
        for key, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(v), rtol=RTOL, atol=1e-6,
                                       err_msg=f"{weights} {key}")
    assert float(metrics["filip_loss"].detach()) > 0


def test_loss_gradients_match_jax(jax_runs):
    """The gradient of ``defilip_losses`` under the recipe's weights with
    respect to every float output of the ``aug-topk`` forward: the filip
    term's four pairings (eight late interactions, K3-K5's plain versions
    here) and every other term, back to the features."""
    want, _ = jax_runs["aug-topk"]
    port = _port(jax_runs, "aug-topk")
    jbank = jax_runs["bank"]
    state = new_train_state(model=port, opt_state=None, step=3,
                            bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    with torch.no_grad():
        out = port(_torch_batch(jax_runs["batch"]))
    leaves = {}

    def leaf(name, t):
        if not t.is_floating_point():
            return t
        leaves[name] = t.detach().requires_grad_()
        return leaves[name]

    out = {key: (tuple(leaf(f"{key}[{i}]", t) for i, t in enumerate(v))
                 if isinstance(v, tuple) else leaf(key, v))
           for key, v in out.items()}
    total, _ = make_losses_from_out(_cfg(WEIGHTS), "defilip",
                                    total_steps=8)(port, state, out)
    got = dict(zip(leaves, torch.autograd.grad(
        total, list(leaves.values()), allow_unused=True)))
    wants = {}
    for key, g in jax_runs["out_grads"].items():
        wants.update(_flat(g, key))
    assert sorted(got) == sorted(n for n, w in wants.items()
                                 if np.issubdtype(w.dtype, np.floating))
    for name, g in got.items():
        w = wants[name]
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        _close(g, w, name, rtol=1e-3)
    dense = [n for n in got if n.startswith("dense_")]
    assert len(dense) == 12  # each pairing's four feature sets
    for name in dense:
        assert np.abs(wants[name]).max() > 0, name


def test_gradients_match_jax(jax_runs):
    """Every parameter's gradient of tiny_defilip's loss at its
    trajectory's first step, the bank's neighbours included, against the
    gradient JAX's train step took there."""
    traj = jax_runs["trajectory"]
    cfg, mcfg, _ = _tiny(TINY)
    want = state_from_jax_variables({"params": traj["grads"]})
    port = model_entry(mcfg)
    port.load_state_dict(state_from_jax_variables(traj["variables"]),
                         strict=True)
    jbank = traj["bank"]
    state = new_train_state(model=port.train(), opt_state=None,
                            bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    named = dict(port.named_parameters())
    total, _ = make_losses_from_out(
        _tiny_loss_cfg(cfg), "defilip", total_steps=MAX_ITER)(
        port, state, port(_torch_batch(traj["batch"])))
    np.testing.assert_allclose(float(total.detach()),
                               traj["hist"][0]["loss"], rtol=RTOL)
    got = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    assert sorted(want) == sorted(named)
    for (pname, p), g in zip(named.items(), got):
        g = np.zeros(p.shape, np.float32) if g is None else g.numpy()
        w = want[pname].numpy()
        rows = _noise_slice(pname, g)
        if rows is not None:  # rounding noise on both sides
            scale = max(np.abs(np.delete(g, rows)).max(initial=0), 1e-3)
            assert np.abs(g[rows]).max(initial=0) <= 1e-5 * scale, pname
            assert np.abs(w[rows]).max(initial=0) <= 1e-5 * scale, pname
            g, w = np.delete(g, rows), np.delete(w, rows)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6, err_msg=pname)
    for pname in ("image_mapping.weight", "text_mapping.weight",
                  "logit_scale_dense"):
        assert np.abs(want[pname].numpy()).max() > 0, pname


def test_fuse_views_changes_no_output(jax_runs):
    """``fuse_views`` runs both text passes as one batch and both views as
    one, with the same rows out."""
    batch = _torch_batch(_batch(RES, 4))
    outs = []
    for fuse in (False, True):
        port = _port(jax_runs, "aug-topk")
        port.fuse_views = fuse
        with torch.no_grad():
            outs.append(port(batch))
    for key in outs[0]:
        for sub, w in _flat(outs[0][key], key).items():
            _close(_flat(outs[1][key], key)[sub].numpy(), w.numpy(), sub,
                   rtol=1e-5)


def test_trajectory_of_tiny_defilip_matches_jax(jax_runs):
    """experiments/unit/tiny_defilip's model, loss weights, guard and EMA
    decay, with tests/test_torch_declip.py's AdamW and schedule, four steps
    on one batch, the bank included."""
    traj = jax_runs["trajectory"]
    cfg, mcfg, ema = _tiny(TINY)
    jhist, jstate, batch = traj["hist"], traj["state"], traj["batch"]
    launches = fli.late_interaction_fwd.launches
    port, state, hist, start = _port_trajectory(
        mcfg, _tiny_loss_cfg(cfg), ema, traj["variables"],
        _torch_batch(batch), traj["bank"])
    assert fli.late_interaction_fwd.launches == launches  # CPU: no kernel
    for i, (metrics, want) in enumerate(zip(hist, jhist)):
        assert sorted(k for k in metrics if k != "logit_clip_count") == \
            sorted(k for k in want if k != "logit_clip_count")
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, err_msg=f"step {i} {key}")
        for key in ("clip_loss", "simsiam_loss", "text_mlm_loss",
                    "clip_nn_text_loss", "filip_loss", "top1", "top5",
                    "logit_scale", "lr"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, atol=RTOL,
                                       err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == want["update_skipped"] == 0.0
    assert state.bank_text.ptr == int(jstate.bank_text.ptr) == \
        2 * batch["tokens"].shape[0] * STEPS
    _close(state.bank_text.bank.numpy(), jstate.bank_text.bank, "bank")
    lr_sum = sum(h["lr"] for h in jhist)
    final = {n: t.numpy() for n, t in state_from_jax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    got = {n: t.detach().numpy() for n, t in port.state_dict().items()}
    assert sorted(got) == sorted(final)
    _assert_close(got, final, {**start, **{n: got[n] for n in got
                                           if n not in start}},
                  lr_sum, "state")
    shadow = state_from_jax_variables({"params": jstate.ema_params})
    _assert_close({n: e.numpy() for n, e in state.ema_params.items()},
                  {n: t.numpy() for n, t in shadow.items()},
                  {n: np.zeros_like(a) for n, a in start.items()},
                  lr_sum, "ema")
    np.testing.assert_allclose(float(state.logit_ema_buffer),
                               float(jstate.logit_ema_buffer), rtol=RTOL)


def test_declip_refuses_return_filip_as_jax():
    """``return_filip`` is DeFILIP's: JAX's DECLIP, a flax dataclass, has
    no such field, and the port's DECLIP refuses the kwarg too."""
    cfg = {"type": "declip_vitb32",
           "kwargs": {**MODEL["kwargs"],
                      "clip": {**MODEL["kwargs"]["clip"],
                               "return_filip": True}}}
    for entry in (jax_model_entry, model_entry):
        with pytest.raises(TypeError, match="return_filip"):
            entry(cfg)
