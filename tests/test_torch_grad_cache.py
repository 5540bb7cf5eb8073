"""GradCache in the port (declip_tpu_torch/train/grad_cache.py) against the
unchunked step and against the JAX package's cached step, on the tiny CLIP
ViT of tests/test_torch_train.py and the tiny FILIP ViT of
tests/test_torch_filip.py (the CLIP and dense terms; JAX's cached step
takes no MLM head, whose labels are integers),
``chunks: 2``, fp32, from one JAX init.

- The loss and every parameter's gradient of the three passes against the
  unchunked forward and backward of the port, and against JAX's
  ``make_cached_value_and_grad`` over its model and method loss: rtol
  1e-5, with an absolute floor of 1e-5 of the tensor's largest gradient
  (the key rows of ``in_proj_bias`` have a gradient of 0 in exact
  arithmetic, rounding noise in each package). The embedding pass's
  outputs equal the gradient pass's re-forward bit for bit on the CPU.
- The step through ``make_train_step`` with ``grad_cache`` against the
  step without it: one SGD update, the parameters within rtol 1e-5 and
  1e-5 of the tensor's largest update.
- The refusals, with the JAX package's reasons: BatchNorm in the forward
  (a ResNet tower; DeCLIP's SimSiam heads), MoE towers, the SSL methods.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.train import method_losses as jax_method_losses
from declip_tpu.train.grad_cache import make_cached_value_and_grad

import test_torch_filip as tfilip
import test_torch_train as ttrain

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.optim import optim_entry
from declip_tpu_torch.train import (
    make_losses_from_out,
    make_train_step,
    new_train_state,
)
from declip_tpu_torch.train.grad_cache import cached_value_and_grad

RTOL = FLOOR = 1e-5
CHUNKS = 2


def _filip_batch():
    b = {k: v for k, v in tfilip._batch().items()
         if k in ("images", "tokens")}
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in b.items()}, b


def _clip_batch():
    b = ttrain._batch()
    return ttrain._torch_batch(b), b


# FILIP without its MLM head: JAX's cached step differentiates every
# output, and the MLM labels are integers
FILIP_CFG = {"type": tfilip.MODEL_CFG["type"], "kwargs": {
    **tfilip.MODEL_CFG["kwargs"],
    "clip": {**tfilip.MODEL_CFG["kwargs"]["clip"], "text_mask_type": None}}}
CASES = {  # model config, method, loss config, batch
    "clip": (ttrain._model_cfg(), "clip", {}, _clip_batch),
    "filip": (FILIP_CFG, "filip",
              tfilip._cfg({"clip_loss": 0.4, "clip_dense_loss": 1.0}),
              _filip_batch),
}


@pytest.fixture(scope="module")
def runs():
    """{case: (numpy params, the JAX cached loss and port-named grads)}."""
    out = {}
    for name, (cfg, method, loss_cfg, make_batch) in CASES.items():
        model = jax_model_entry(cfg)
        _, batch = make_batch()
        params = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda: model.init(jax.random.PRNGKey(0), batch,
                               train=True))()["params"])
        losses = getattr(jax_method_losses, f"{method}_losses")

        def forward_out(p, state, b, model=model):
            return model.apply({"params": p}, b, train=True,
                               mutable=["batch_stats", "moe"])

        def losses_from_out(p, o, state, moe, losses=losses,
                            loss_cfg=loss_cfg):
            return losses(o, loss_cfg, None)

        vg = make_cached_value_and_grad(forward_out, losses_from_out,
                                        CHUNKS)
        (total, _), grads = jax.jit(lambda p, b: vg(p, None, b))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        out[name] = (params, float(total), state_from_jax_variables(
            {"params": jax.tree_util.tree_map(np.asarray, grads)}))
    return out


def _port(name, params):
    cfg = CASES[name][0]
    model = model_entry(cfg)
    model.load_state_dict(state_from_jax_variables({"params": params}),
                          strict=True)
    return model.train()


def _close(got, want, what):
    want = np.asarray(want)
    atol = FLOOR * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=max(atol, 1e-12), err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_cached_gradients_match_unchunked_and_jax(runs, name):
    params, jtotal, jgrads = runs[name]
    _, method, loss_cfg, make_batch = CASES[name]
    batch, _ = make_batch()
    model = _port(name, params)
    named = dict(model.named_parameters())
    from_out = make_losses_from_out(loss_cfg, method)
    diff = {}
    total, metrics, out, grads = cached_value_and_grad(
        model, from_out, None, batch, CHUNKS, named, reforward_diff=diff)
    assert diff["max_abs"] == 0.0
    assert out["image_embed"].shape[0] == batch["images"].shape[0]
    ref_total, _ = from_out(model, None, model(batch))
    ref = torch.autograd.grad(ref_total, list(named.values()),
                              allow_unused=True)
    np.testing.assert_allclose(float(total.detach()),
                               float(ref_total.detach()), rtol=RTOL)
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=RTOL)
    for (n, p), r in zip(named.items(), ref):
        g = grads[n]
        g = torch.zeros_like(p) if g is None else g
        r = torch.zeros_like(p) if r is None else r
        _close(g.detach(), r.detach(), f"{n} vs unchunked")
        _close(g.detach(), jgrads[n].numpy(), f"{n} vs JAX")


@pytest.mark.parametrize("name", list(CASES))
def test_grad_cache_step_equals_the_unchunked_step(runs, name):
    params, _, _ = runs[name]
    _, method, loss_cfg, make_batch = CASES[name]
    batch, _ = make_batch()
    start = {n: p.detach().numpy().copy()
             for n, p in _port(name, params).named_parameters()}
    after = []
    for cfg in (loss_cfg, {**loss_cfg, "grad_cache": {"chunks": CHUNKS}}):
        model = _port(name, params)
        named = dict(model.named_parameters())
        tx = optim_entry({"type": "SGD", "kwargs": {}}, model,
                         lambda step: 0.5)
        state = new_train_state(model=model, opt_state=tx.init(named))
        step = make_train_step(model, tx, cfg, lambda step: 0.5)
        state, metrics = step(state, batch)
        assert metrics["update_skipped"] == 0.0
        after.append({n: p.detach().numpy().copy()
                      for n, p in named.items()})
    for n, p in after[1].items():
        moved = float(np.abs(after[0][n] - start[n]).max())
        np.testing.assert_allclose(p, after[0][n], rtol=RTOL,
                                   atol=max(1e-12, FLOOR * moved), err_msg=n)


def _tiny(mtype, **visual):
    tower = ({"layers": [1, 1, 1, 1], "width": 8} if "res50" in mtype
             else {"patch_size": 16, "width": 16, "layers": 1})
    return {"type": mtype, "kwargs": {
        "image_encode": {"embed_dim": 16, "input_resolution": 32,
                         "heads": 2, **tower, **visual},
        "text_encode": {"embed_dim": 16, "transformer_width": 16,
                        "transformer_heads": 2, "transformer_layers": 1,
                        "vocab_size": 50},
        "clip": {"feature_dim": 16} if mtype.startswith("declip") else {}}}


@pytest.mark.parametrize("kind,match", [
    ("bn_tower", "BatchNorm-free"), ("simsiam_heads", "BatchNorm-free"),
    ("moe", "MoE"), ("ssl", "SSL methods")])
def test_grad_cache_refusals(kind, match):
    method = None
    if kind == "bn_tower":
        model = model_entry(_tiny("clip_res50"), device="meta")
    elif kind == "simsiam_heads":
        model = model_entry(_tiny("declip_vitb32"), device="meta")
    else:
        model = model_entry(_tiny("clip_vitb32"), device="meta")
        if kind == "moe":
            model.encode_text.moe_experts = 4
        else:
            method = "simclr"
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(model, None, {"grad_cache": {"chunks": 2}},
                        lambda step: 0.0, method=method)
