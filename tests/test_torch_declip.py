"""The port's DeCLIP (declip_tpu_torch.models.declip_model), its losses and
its training step against the JAX package's, on two tiny models from the
JAX init carried over by ``state_from_jax_variables`` (params and
batch_stats) and ``bank_from_jax``:

- ``declip_res50`` at layers (1, 1, 1, 1), width 8, 64 px, a 32-wide
  2-layer text tower, with every head on (MLM, the NN bank, text SimSiam,
  nn-SimSiam);
- ``declip_vitb32`` at the experiments/unit/tiny_declip widths with its
  recipe, its ``logit_scale_param_ema`` guard and an EMA.

Checked: the feature dict; every loss term under the four weight types;
the gradients; a 4-step fp32 trajectory of ``make_train_step`` against
JAX's (losses, params, BatchNorm running statistics, the bank and its
pointer across a wrap, the EMA); the bank's ``enqueue`` and ``query_topk``;
a planted-NaN step; the optimizer groups of the BatchNorm parameters; the
variants the port does not train yet (DeFILIP's ``return_filip``, which
DECLIP refuses as JAX's does: tests/test_torch_defilip.py).

Tolerances: rtol 1e-4 (atol 1e-4 on metrics near zero and on parameters),
as tests/test_torch_filip.py. Parameters whose gradient is 0 in exact
arithmetic (a bias right before a BatchNorm, which the batch mean removes;
attnpool's key bias, which the softmax removes; the key rows of
``in_proj_bias``) are held to Adam's step bound, as tests/test_torch_train.py
holds the key rows, and the running means of the BatchNorms right after
those biases to what those steps can move them.

Each image is noise around a colour of its own. Images of pure noise give a
random tower nearly equal embeddings, and the SimSiam heads' BatchNorm over
8 nearly equal rows divides by a tiny batch deviation: it amplified the
packages' fp32 rounding about 50-fold (1.3e-6 on the image embedding,
1.5e-4 on the projector's output) where distinct images do not.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.config import parse_config as jax_parse_config
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.models.clip_model import l2_normalize as jax_l2_normalize
from declip_tpu.models.memory_bank import BankState as JaxBankState
from declip_tpu.models.memory_bank import enqueue as jax_enqueue
from declip_tpu.models.memory_bank import init_bank as jax_init_bank
from declip_tpu.models.memory_bank import query_topk as jax_query_topk
from declip_tpu.optim import optim_entry as jax_optim_entry
from declip_tpu.optim import scheduler_entry as jax_scheduler_entry
from declip_tpu.optim.param_groups import path_prefix_mask as jax_prefix_mask
from declip_tpu.tools.convert import variables_to_torch_state
from declip_tpu.train import EmaConfig as JaxEmaConfig
from declip_tpu.train import init_ema as jax_init_ema
from declip_tpu.train import make_train_step as jax_make_train_step
from declip_tpu.train import new_train_state as jax_new_train_state
from declip_tpu.train.method_losses import declip_losses as jax_declip_losses

from declip_tpu_torch.convert import bank_from_jax, state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.declip_model import DECLIP
from declip_tpu_torch.models.layers import BatchNorm
from declip_tpu_torch.models.memory_bank import (
    BankState,
    enqueue,
    init_bank,
    query_topk,
)
from declip_tpu_torch.optim import (
    group_labels,
    optim_entry,
    path_prefix_mask,
    scheduler_entry,
)
from declip_tpu_torch.tokenizer.mlm import mask_tokens
from declip_tpu_torch.train import (
    EmaConfig,
    init_ema,
    make_losses_from_out,
    make_train_step,
    method_of,
    new_train_state,
)

VOCAB, B, STEPS, BANK = 100, 8, 4, 48
MASK, SOT, EOT = VOCAB - 3, VOCAB - 2, VOCAB - 1  # the BPE vocab's order
RTOL = ATOL = SHARE = 1e-4
MODELS = {
    "res50": ({"type": "declip_res50", "kwargs": {
        "image_encode": {"embed_dim": 64, "layers": (1, 1, 1, 1),
                         "width": 8, "heads": 4, "input_resolution": 64},
        "text_encode": {"embed_dim": 64, "transformer_width": 32,
                        "transformer_heads": 2, "transformer_layers": 2,
                        "vocab_size": VOCAB},
        "clip": {"use_allgather": True, "text_mask_type": "MLM",
                 "return_nn_bank": True, "return_simsiam_text": True,
                 "return_simsiam_nn_text": True, "feature_dim": 64,
                 "nn_size": BANK, "EDA": True},
        "dtype": "float32"}}, 64),
    # experiments/unit/tiny_declip/config.yaml
    "vitb32": ({"type": "declip_vitb32", "kwargs": {
        "image_encode": {"embed_dim": 64, "input_resolution": 224,
                         "patch_size": 32, "width": 64, "layers": 2,
                         "heads": 2},
        "text_encode": {"embed_dim": 64, "transformer_width": 64,
                        "transformer_heads": 2, "transformer_layers": 2,
                        "vocab_size": VOCAB},
        "clip": {"use_allgather": True, "text_mask_type": "MLM",
                 "return_nn_bank": True, "nn_size": BANK, "feature_dim": 64,
                 "EDA": True},
        "dtype": "float32"}}, 224),
}
# the yfcc15m_r50_declip recipe's weights, with the two optional SimSiam
# terms on where the model has them
WEIGHTS = {"clip_loss": 0.4, "nn_text": 0.2, "simsiam_loss": 0.2,
           "masking_language": 0.2, "text_simsiam_loss": 0.1,
           "nn_simsiam_loss": 0.1}
WEIGHT_TYPES = {None: WEIGHTS, "convirt": {"type": "convirt",
                                           "clip_loss": 0.5,
                                           "simsiam_loss": 0.5},
                "linear": {"type": "linear"}, "shift": {"type": "shift"}}
GUARDS = {"res50": ({"type": "logit_scale_param_value", "value": 3,
                     "max_value": 6}, None),
          # tiny_declip: the EMA guard and an EMA of decay 0.99
          "vitb32": ({"type": "logit_scale_param_ema", "threshold": 0.2},
                     (0.99, 1, 1, False))}
OPT = {"type": "AdamW", "kwargs": {"lr": 1e-3, "weight_decay": 0.1,
                                   "betas": [0.9, 0.98], "eps": 1e-8}}
PCONFIG = {g: {"weight_decay": 0} for g in
           ("bn_w", "bn_b", "ln_w", "ln_b", "linear_b", "conv_b",
            "logit_scale")}
SCHED = {"type": "Cosine", "kwargs": {"base_lr": 1e-4, "warmup_lr": 1e-3,
                                      "min_lr": 0.0, "warmup_steps": 2}}
MAX_ITER = 10
# biases right before a BatchNorm, and attnpool's key bias: a gradient of 0
# in exact arithmetic
ZERO_GRAD = ("projector.linear1.bias", "projector.linear2.bias",
             "projector.linear3.bias", "predictor.linear1.bias",
             "projector_nn_text.linear1.bias",
             "projector_nn_text.linear2.bias",
             "projector_nn_text.linear3.bias",
             "predictor_nn_text.linear1.bias", "attnpool.k_proj.bias")


# the running means of the BatchNorms right after those biases take in the
# biases' noise steps, 0.1 of each step's bias
MEAN_AFTER_NOISE = tuple(
    n.replace(".linear", ".bn").replace(".bias", ".running_mean")
    for n in ZERO_GRAD if ".linear" in n)


def _noise_slice(name, arr):
    """The part of a parameter whose gradient is 0 in exact arithmetic."""
    if name.endswith(ZERO_GRAD):
        return slice(None)
    if name.endswith("attn.in_proj_bias"):
        width = arr.shape[0] // 3
        return slice(width, 2 * width)
    return None


def _batch(res, seed=0):
    rng = np.random.default_rng(seed)

    def tokens():
        toks = np.zeros((B, 77), np.int32)
        for r in range(B):
            length = int(rng.integers(5, 40))
            toks[r, 0], toks[r, length - 1] = SOT, EOT
            toks[r, 1:length - 1] = rng.integers(1, MASK, size=length - 2)
        return toks

    toks, toks_aug = tokens(), tokens()
    mlm_tokens, mlm_labels = mask_tokens(
        toks, mask_id=MASK, vocab_size=VOCAB, special_ids=(SOT, EOT),
        rng=rng, mlm_probability=0.3)
    # noise around a colour of each image's own
    images = rng.normal(size=(B, res, res, 6)) + rng.normal(size=(B, 1, 1, 6))
    return {"images": images.astype(np.float32),
            "tokens": toks, "tokens_aug": toks_aug,
            "mlm_tokens": mlm_tokens.astype(np.int32),
            "mlm_labels": mlm_labels.astype(np.int32)}


def _torch_batch(batch):
    out = {"images": torch.from_numpy(batch["images"])}
    for key in ("tokens", "tokens_aug", "mlm_tokens", "mlm_labels"):
        out[key] = torch.from_numpy(batch[key]).long()
    return out


def _cfg(name, weights=WEIGHTS):
    return {"clip_simsiam_loss_weight": dict(weights),
            "grad_clip": dict(GUARDS[name][0])}


@pytest.fixture(scope="module")
def jax_init():
    """{model: (jax module, numpy variables, jax bank)}."""
    out = {}
    for name, (cfg, res) in MODELS.items():
        model = jax_model_entry(cfg)
        batch = _batch(res)
        v = jax.jit(lambda model=model, batch=batch: model.init(
            jax.random.PRNGKey(0), batch, train=True))()
        bank = jax_init_bank(jax.random.PRNGKey(1), BANK, 64)
        out[name] = (model, jax.tree_util.tree_map(np.asarray, dict(v)),
                     bank)
    return out


def _port_model(name, variables):
    model = model_entry(MODELS[name][0])
    model.load_state_dict(state_from_jax_variables(variables), strict=True)
    return model.train()


def _jax_out(model, variables, batch):
    return jax.jit(lambda v, b: model.apply(v, b, train=True,
                                            mutable=["batch_stats"]))(
        variables, batch)


def _jax_nn(model, variables, bank, out):
    """The JAX step's bank inputs to declip_losses (train_step.py:149-170)."""
    nn = tuple(jax_l2_normalize(t, eps=1e-10)
               for t in jax_query_topk(bank, out["text_embed"], 1))
    nn_aug = tuple(jax_l2_normalize(t, eps=1e-10)
                   for t in jax_query_topk(bank, out["text_embed_aug"], 1))
    kw = {"nn_text": nn, "nn_text_aug": nn_aug}
    if "nn_simsiam_p_text" in out:
        z_nn = [model.apply(variables, t, method="project_nn_text")
                for t in nn]
        kw["nn_simsiam"] = (out["nn_simsiam_p_text"], z_nn)
    return kw


def _close(got, want, what, rtol=RTOL):
    """rtol, with an atol of SHARE of the tensor's largest magnitude (1e-5
    at least)."""
    want = np.asarray(want)
    atol = max(1e-5, SHARE * np.abs(want).max(initial=0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _flat(tree, prefix=""):
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_losses_match_jax(jax_init, name):
    """The feature dict, and every loss term under each weight type with
    the bank's neighbours, at step 3 of 8 (the linear and shift weights
    read the step)."""
    jmodel, variables, jbank = jax_init[name]
    batch = _batch(MODELS[name][1], 1)
    want, _ = _jax_out(jmodel, variables, batch)
    port = _port_model(name, variables)
    assert isinstance(port, DECLIP) and method_of(port) == "declip"
    tbatch = _torch_batch(batch)
    got = port(tbatch)
    assert sorted(got) == sorted(want)
    for key in want:
        for sub, w in _flat(want[key], key).items():
            g = _flat(got[key], key)[sub].detach().numpy()
            assert g.shape == np.shape(w), sub
            _close(g, w, sub)

    bank = bank_from_jax(jbank.bank, jbank.ptr)
    state = new_train_state(model=port, opt_state=None, step=3,
                            bank_text=bank)

    def jax_terms(v, o):  # every weight type in one compile
        nn = _jax_nn(jmodel, v, jbank, o)
        return [jax_declip_losses(o, _cfg(name, weights), None, step=3,
                                  total_steps=8, **nn)
                for weights in WEIGHT_TYPES.values()]

    jterms = jax.jit(jax_terms)(variables, want)
    for (wtype, weights), (jtotal, jmetrics) in zip(WEIGHT_TYPES.items(),
                                                    jterms):
        cfg = _cfg(name, weights)
        total, metrics = make_losses_from_out(cfg, "declip", total_steps=8)(
            port, state, got)
        assert sorted(metrics) == sorted(jmetrics), wtype
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=RTOL, err_msg=str(wtype))
        for key, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(v), rtol=RTOL, atol=1e-6,
                                       err_msg=f"{wtype} {key}")


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_jax(jax_init, name):
    jmodel, variables, jbank = jax_init[name]
    batch = _batch(MODELS[name][1], 2)
    cfg = _cfg(name)

    def loss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        out, _ = jmodel.apply(v, batch, train=True, mutable=["batch_stats"])
        return jax_declip_losses(out, cfg, None,
                                 **_jax_nn(jmodel, v, jbank, out))[0]

    jloss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = state_from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})
    port = _port_model(name, variables)
    state = new_train_state(model=port, opt_state=None,
                            bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    named = dict(port.named_parameters())
    total, _ = make_losses_from_out(cfg, "declip")(port, state,
                                                  port(_torch_batch(batch)))
    np.testing.assert_allclose(float(total.detach()), float(jloss),
                               rtol=RTOL)
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


def _assert_close(got, want, start, lr_sum, what):
    """{port name: array}; the noise slices within Adam's step bound of
    their start."""
    for name, g in got.items():
        w = want[name]
        if name.endswith(MEAN_AFTER_NOISE):
            # each side's bias within lr_sum of one start: the two apart by
            # 2 lr_sum at most, of which the mean takes 1 - 0.9^STEPS
            np.testing.assert_allclose(
                g, w, rtol=RTOL,
                atol=ATOL + 2 * lr_sum * (1 - 0.9 ** STEPS) * 1.001,
                err_msg=f"{what} {name}")
            continue
        rows = _noise_slice(name, g)
        if rows is not None:
            for side in (g, w):
                assert np.abs(side[rows] - start[name][rows]).max() <= \
                    lr_sum * 1.001, (what, name)
            g, w = np.delete(g, rows), np.delete(w, rows)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


def _run_jax(name, jmodel, variables, jbank, batch):
    grad_clip, ema = GUARDS[name]
    params = variables["params"]
    sched = jax_scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = jax_optim_entry(OPT, params, sched, pconfig=PCONFIG,
                         grad_clip=grad_clip,
                         frozen_mask=jax_prefix_mask(params,
                                                     ("patch_embed",)))
    ema_cfg = JaxEmaConfig(*ema) if ema else None
    state = jax_new_train_state(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=tx.init(params),
        ema_params=jax_init_ema(params, ema_cfg) if ema else None,
        bank_text=JaxBankState(jnp.asarray(jbank.bank),
                               jnp.asarray(jbank.ptr)),
        with_logit_guard=grad_clip["type"] == "logit_scale_param_ema")
    cfg = jax_parse_config("x: 0")
    cfg.update(_cfg(name))
    step = jax.jit(jax_make_train_step(jmodel, tx, cfg, sched,
                                       ema_cfg=ema_cfg, total_steps=MAX_ITER))
    history = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return jax.device_get(state), history


@pytest.mark.parametrize("name", list(MODELS))
def test_trajectory_matches_jax(jax_init, name):
    """Four steps on one batch: 2B = 16 features a step into a bank of 48
    rows, so the third step's second write fills the bank's end and the
    pointer wraps to 0."""
    jmodel, variables, jbank = jax_init[name]
    batch = _batch(MODELS[name][1])
    jstate, jhist = _run_jax(name, jmodel, variables, jbank, batch)

    grad_clip, ema = GUARDS[name]
    port = _port_model(name, variables)
    named = dict(port.named_parameters())
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, port, sched, pconfig=PCONFIG, grad_clip=grad_clip,
                     frozen_mask=path_prefix_mask(
                         named, port.visual.frozen_param_paths()))
    ema_cfg = EmaConfig(*ema) if ema else None
    state = new_train_state(
        model=port, opt_state=tx.init(named),
        ema_params=init_ema(named, ema_cfg) if ema else None,
        with_logit_guard=grad_clip["type"] == "logit_scale_param_ema",
        bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    step = make_train_step(port, tx, _cfg(name), sched, ema_cfg=ema_cfg,
                           total_steps=MAX_ITER)
    start = {n: p.detach().numpy().copy() for n, p in named.items()}
    tbatch = _torch_batch(batch)
    ptrs = []
    for i in range(STEPS):
        state, metrics = step(state, tbatch)
        ptrs.append(state.bank_text.ptr)
        want = jhist[i]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, err_msg=f"step {i} {key}")
        for key in ("clip_loss", "simsiam_loss", "text_mlm_loss",
                    "clip_nn_text_loss", "text_simsiam_loss", "top1",
                    "top5", "logit_scale", "lr"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == want["update_skipped"] == 0.0
    assert ptrs == [16, 32, 0, 16] and state.bank_text.ptr == \
        int(jstate.bank_text.ptr)
    np.testing.assert_allclose(state.bank_text.bank.numpy(),
                               np.asarray(jstate.bank_text.bank),
                               rtol=RTOL, atol=1e-5)

    lr_sum = sum(h["lr"] for h in jhist)
    final = {n: t.numpy() for n, t in state_from_jax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    got = {n: t.detach().numpy() for n, t in port.state_dict().items()}
    assert sorted(got) == sorted(final)
    _assert_close(got, final, {**start, **{n: got[n] for n in got
                                           if n not in start}},
                  lr_sum, "state")
    if ema:
        shadow = state_from_jax_variables({"params": jstate.ema_params})
        _assert_close({n: e.numpy() for n, e in state.ema_params.items()},
                      {n: t.numpy() for n, t in shadow.items()},
                      {n: np.zeros_like(a) for n, a in start.items()},
                      lr_sum, "ema")
        np.testing.assert_allclose(float(state.logit_ema_buffer),
                                   float(jstate.logit_ema_buffer), rtol=RTOL)


def test_planted_nan_step_changes_nothing(jax_init):
    """A NaN in the images makes the loss NaN: the step reports
    update_skipped and leaves the params, the optimizer state, the BatchNorm
    buffers, the bank and its pointer bit for bit as they were."""
    _, variables, jbank = jax_init["res50"]
    port = _port_model("res50", variables)
    named = dict(port.named_parameters())
    sched = scheduler_entry(SCHED, max_iter=MAX_ITER)
    tx = optim_entry(OPT, port, sched, pconfig=PCONFIG,
                     grad_clip=GUARDS["res50"][0])
    state = new_train_state(model=port, opt_state=tx.init(named),
                            bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    step = make_train_step(port, tx, _cfg("res50"), sched)
    batch = _torch_batch(_batch(64))
    state, metrics = step(state, batch)  # one good step first
    assert metrics["update_skipped"] == 0.0 and state.bank_text.ptr == 16
    before = {k: v.clone() for k, v in port.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    bank, ptr, count = state.bank_text.bank.clone(), state.bank_text.ptr, \
        state.opt_state.count
    batch["images"][0, 3, 5, 1] = float("nan")
    state, metrics = step(state, batch)
    assert metrics["update_skipped"] == 1.0 and state.step == 2
    assert not np.isfinite(float(metrics["loss"]))
    after = port.state_dict()
    assert any(k.endswith("running_var") for k in after)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    for k, v in mu.items():
        assert torch.equal(state.opt_state.mu[k], v), k
    assert state.opt_state.count == count
    assert torch.equal(state.bank_text.bank, bank)
    assert state.bank_text.ptr == ptr
    assert all(m.pending is None for m in port.modules()
               if isinstance(m, BatchNorm))


def test_enqueue_wraps_as_jax():
    """Writes of 5 rows into 12: at 0, 5, then clamped to 7 with the
    pointer wrapped to 0, then 0 again."""
    rng = np.random.default_rng(0)
    bank = rng.normal(size=(12, 4)).astype(np.float32)
    jstate = JaxBankState(jnp.asarray(bank), jnp.asarray(0, jnp.int32))
    state = BankState(torch.from_numpy(bank.copy()), 0)
    ptrs = []
    for i in range(4):
        rows = rng.normal(size=(5, 4)).astype(np.float32)
        jstate = jax_enqueue(jstate, jnp.asarray(rows))
        state = enqueue(state, torch.from_numpy(rows))
        ptrs.append(state.ptr)
        assert state.ptr == int(jstate.ptr)
        np.testing.assert_array_equal(state.bank.numpy(),
                                      np.asarray(jstate.bank))
    assert ptrs == [5, 10, 0, 5]


@pytest.mark.parametrize("topk", [1, 2])
def test_query_topk_matches_jax(topk):
    """k nearest rows by cosine, with an exact tie (a row copied) that
    both packages break towards the lower index."""
    rng = np.random.default_rng(1)
    bank = rng.normal(size=(64, 16)).astype(np.float32)
    bank[40] = bank[7]
    x = rng.normal(size=(6, 16)).astype(np.float32)
    x[2] = bank[7] * 3.0
    want = jax_query_topk(JaxBankState(jnp.asarray(bank), jnp.asarray(0)),
                          jnp.asarray(x), topk)
    got = query_topk(BankState(torch.from_numpy(bank), 0),
                     torch.from_numpy(x), topk)
    assert len(got) == len(want) == topk
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_bank_rows_are_unit_vectors():
    state = init_bank(torch.Generator().manual_seed(0), 32, 8)
    assert state.ptr == 0 and state.bank.dtype == torch.float32
    np.testing.assert_allclose(
        torch.linalg.vector_norm(state.bank, dim=-1).numpy(), 1.0, rtol=1e-6)


def test_state_dict_equals_jax_converter(jax_init):
    """The port's converter gives what declip_tpu.tools.convert writes for
    a DeCLIP-R50 with its batch_stats, and exactly the port's state."""
    _, variables, _ = jax_init["res50"]
    ours = state_from_jax_variables(variables)
    theirs = variables_to_torch_state(variables)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), k)
    assert set(model_entry(MODELS["res50"][0]).state_dict()) == set(ours)
    assert tuple(ours["visual.layer2.0.downsample.0.weight"].shape) == \
        (64, 32, 1, 1)
    assert "visual.layer1.0.bn3.running_var" in ours


def test_bn_parameters_take_the_bn_groups():
    """Every BatchNorm scale and bias, in the tower and in the heads, is in
    bn_w / bn_b, so that the recipe's pconfig takes their decay off."""
    model = model_entry(MODELS["res50"][0])
    labels = group_labels(model)
    bn = {f"{n}.{p}" for n, m in model.named_modules()
          if isinstance(m, BatchNorm) for p in ("weight", "bias")}
    assert len(bn) == 2 * sum(isinstance(m, BatchNorm)
                              for m in model.modules()) > 40
    for name, group in labels.items():
        want = ("bn_w" if name.endswith("weight") else "bn_b") \
            if name in bn else None
        if want:
            assert group == want, name
        else:
            assert group not in ("bn_w", "bn_b"), name


def _unported(kind):
    cfg = {"type": "declip_res50",
           "kwargs": {k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in MODELS["res50"][0]["kwargs"].items()}}
    kw = cfg["kwargs"]
    if kind == "logit_bias":
        kw["clip"]["logit_bias_init"] = -10.0
    elif kind == "hf_text":
        kw["text_encode"]["text_encode_type"] = "Bert"
    elif kind == "moe":
        kw["image_encode"]["moe"] = {"num_experts": 4}
    model_entry(cfg)


@pytest.mark.parametrize("kind,error,match", [
    ("hf_text", FileNotFoundError, "needs local pretrained files"),
    ("moe", TypeError, "moe_experts")])
def test_unported_variants_raise(kind, error, match, monkeypatch):
    """A MoE ResNet tower fails loudly, as in the JAX package (an unknown
    kwarg; the transformer towers take MoE: tests/test_torch_moe.py); a
    Bert text tower is ported (models/hf_text.py), and without local
    weights it raises as the JAX package's does."""
    monkeypatch.delenv("DECLIP_HF_TEXT_PATH", raising=False)
    with pytest.raises(error, match=match):
        _unported(kind)


def test_grad_cache_refuses_the_batchnorm_model():
    """GradCache on DeCLIP-R50 raises with the JAX package's reason: its
    BatchNorm couples the samples inside the forward."""
    model = model_entry(MODELS["res50"][0])
    with pytest.raises(NotImplementedError, match="BatchNorm-free towers"):
        make_train_step(model, None, {"grad_cache": {"chunks": 2}},
                        lambda i: 0.0)


@pytest.mark.parametrize("kind", ["logit_bias", "chunked", "ring",
                                  "sigmoid"])
def test_loss_impl_matches_jax(jax_init, kind):
    """DeCLIP-R50's loss under the ``loss_impl`` kinds the port refused
    before they were ported (the NN-text term blockwise under every kind
    but ``full``), and with a SigLIP ``logit_bias`` (logit_bias_init -10,
    the SigLIP recipe's ``sigmoid_ring``, JAX's over a one-device mesh):
    the total and every metric against JAX's on the same outputs."""
    from jax.sharding import Mesh

    from declip_tpu.ops.contrastive import make_pair_loss as jax_pair_loss

    jmodel, variables, jbank = jax_init["res50"]
    cfg = MODELS["res50"][0]
    if kind == "logit_bias":
        cfg = {"type": cfg["type"], "kwargs": {
            **cfg["kwargs"], "clip": {**cfg["kwargs"]["clip"],
                                      "logit_bias_init": -10.0}}}
        jmodel = jax_model_entry(cfg)
        variables = {**variables, "params": {
            **variables["params"],
            "logit_bias": np.full((1,), -10.0, np.float32)}}
    loss_cfg = {**_cfg("res50"), "loss_impl": {
        "type": "sigmoid_ring" if kind == "logit_bias" else kind,
        "chunk_size": 3, "acc_window": 4}}
    batch = _batch(MODELS["res50"][1], 2)
    want, _ = _jax_out(jmodel, variables, batch)
    pair = jax_pair_loss(loss_cfg, mesh=Mesh(np.asarray(jax.devices()[:1]),
                                             ("data",)))
    jtotal, jmetrics = jax.jit(lambda v, o: jax_declip_losses(
        o, loss_cfg, None, step=3, total_steps=8, pair_loss=pair,
        **_jax_nn(jmodel, v, jbank, o)))(variables, want)
    port = model_entry(cfg)
    port.load_state_dict(state_from_jax_variables(variables), strict=True)
    got = port.train()(_torch_batch(batch))
    if kind == "logit_bias":
        assert float(got["logit_bias"]) == -10.0
    state = new_train_state(model=port, opt_state=None, step=3,
                            bank_text=bank_from_jax(jbank.bank, jbank.ptr))
    total, metrics = make_losses_from_out(loss_cfg, "declip",
                                          total_steps=8)(port, state, got)
    assert sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=RTOL)
    for key, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key].detach()), float(v),
                                   rtol=RTOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
def test_fuse_views_changes_no_output(jax_init, name):
    """``fuse_views`` runs the two text passes as one batch, and a ViT's two
    views too, with the same rows out; a ResNet's views stay two calls
    (their BatchNorm statistics are per view), so its outputs and running
    statistics are those of the unfused model as well."""
    _, variables, _ = jax_init[name]
    batch = _torch_batch(_batch(MODELS[name][1], 4))
    outs = []
    for fuse in (False, True):
        model = _port_model(name, variables)
        model.fuse_views = fuse
        with torch.no_grad():
            out = model(batch)
        outs.append((out, [m.pending for m in model.modules()
                           if isinstance(m, BatchNorm)]))
    (plain, plain_bn), (fused, fused_bn) = outs
    for key in plain:
        for sub, w in _flat(plain[key], key).items():
            _close(_flat(fused[key], key)[sub].numpy(), w.numpy(), sub,
                   rtol=1e-5)
    for a, b in zip(fused_bn, plain_bn):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                       atol=1e-7)
