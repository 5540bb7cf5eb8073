"""The port's SLIP (declip_tpu_torch.models.slip_model), its NT-Xent losses,
``slip_losses`` and its training step against the JAX package's, the
weights carried over by ``state_from_jax_variables`` (params and
batch_stats). Both start from the port's seeded init, which the JAX
package's own ``torch_state_to_variables`` turns into the JAX model's
variables (sparing a JAX init's compile):

- ``slip_vitb32`` at 64 px, width 64, 2 layers and ``slip_res50`` at layers
  (1, 1, 1, 1), width 8, 64 px, each with a 64-wide 2-layer text tower: the
  feature dict, the BatchNorm statistics the training forward leaves
  (``predictor_sim`` runs twice, and a ResNet tower three times, each call
  moving them on from the last), ``slip_losses`` under the recipe's
  ``loss_weight`` and another;
- ``nt_xent`` and ``nt_xent_gather`` against declip_tpu/losses.py, the
  gathered form with this shard's rows in the middle of a larger batch;
- experiments/unit/tiny_slip's model (224 px, sim_dim 16), loss weights,
  ``logit_scale_param_ema`` guard and EMA, with tests/test_torch_declip.py's
  AdamW and schedule: a 4-step fp32 trajectory of ``make_train_step``, and
  every parameter's gradient at its first step (JAX's read from the same
  compiled step).

Tolerances are tests/test_torch_declip.py's: rtol 1e-4 with an atol of
1e-4 of a tensor's largest magnitude on features and losses; the gradients
rtol 1e-3 with that atol (the SimCLR term at temperature 0.1 gives a
gradient norm near 190, and near-zero elements of a large gradient carry
its fp32 rounding: 7e-6 on the patch embedding's, 8e-6 of its norm), those
that are 0 in exact arithmetic (a bias before a BatchNorm, attnpool's key
bias) held to the noise level; the parameters rtol and atol 1e-4. Each of
the three views is noise around a colour of its own. The trajectory's
parameters: see ``_assert_state_close``.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_declip import (
    RTOL,
    STEPS,
    VOCAB,
    _close,
    _noise_slice,
)

from test_torch_defilip import (
    _jax_trajectory,
    _port_trajectory,
    _seeded_variables,
    _tiny,
)

from declip_tpu import losses as jax_losses_mod
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.train.method_losses import slip_losses as jax_slip_losses

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.losses import nt_xent, nt_xent_gather
from declip_tpu_torch.models import model_entry
from declip_tpu_torch.models.layers import BatchNorm
from declip_tpu_torch.models.slip_model import SLIP
from declip_tpu_torch.train import (
    make_losses_from_out,
    method_of,
)

RES, B = 64, 8
SOT, EOT = VOCAB - 2, VOCAB - 1
TEXT = {"embed_dim": 64, "transformer_width": 64, "transformer_heads": 2,
        "transformer_layers": 2, "vocab_size": VOCAB}
CLIP_KW = {"use_allgather": True, "return_sim": True, "feature_dim": 64,
           "sim_dim": 16}
MODELS = {
    "vitb32": {"type": "slip_vitb32", "kwargs": {
        "image_encode": {"embed_dim": 64, "input_resolution": RES,
                         "patch_size": 16, "width": 64, "layers": 2,
                         "heads": 2},
        "text_encode": TEXT, "clip": CLIP_KW, "dtype": "float32"}},
    "res50": {"type": "slip_res50", "kwargs": {
        "image_encode": {"embed_dim": 64, "layers": (1, 1, 1, 1), "width": 8,
                         "heads": 4, "input_resolution": RES},
        "text_encode": TEXT, "clip": CLIP_KW, "dtype": "float32"}},
}
# the yfcc15m recipes' loss_weight, and one that weighs the terms apart
WEIGHTS = ({"clip_loss": 1, "simclr_loss": 1},
           {"clip_loss": 0.3, "simclr_loss": 2.0})
TINY = "experiments/unit/tiny_slip/config.yaml"
# predictor_sim's biases right before a BatchNorm: a gradient of 0 in exact
# arithmetic (the batch mean removes them), and the running means right
# after them, which take 0.1 of each of their noise steps
SIM_NOISE = ("predictor_sim.linear1.bias", "predictor_sim.linear2.bias")
SIM_MEANS = ("predictor_sim.bn1.running_mean",
             "predictor_sim.bn2.running_mean")


def _noise(name, arr):
    """The part of a parameter whose gradient is 0 in exact arithmetic."""
    return slice(None) if name in SIM_NOISE else _noise_slice(name, arr)


def _assert_state_close(got, want, start, lr_sum, what):
    """Parameters, EMA shadows and BatchNorm statistics after the steps, as
    tests/test_torch_declip.py holds them (rtol and atol 1e-4), except a
    tensor with an element outside that: then the tensor within 1e-4 of its
    norm (||a - b|| <= 1e-4 ||b||) and no element further from the other
    side's than two Adam paths can take it (2 lr_sum, |step| <= lr: Kingma
    & Ba 2015, 2.1). An element whose gradient is at fp32's noise level (a
    few of predictor_sim's 4096-wide layers' million) takes Adam steps of
    up to the lr whose signs follow the noise. predictor_sim's biases
    before a BatchNorm: each side within lr_sum of its start; the running
    means after them within what those steps can move them."""
    for name, g in got.items():
        w = want[name]
        if name in SIM_MEANS:
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=RTOL + 2 * lr_sum * (1 - 0.9 ** STEPS)
                * 1.001, err_msg=f"{what} {name}")
            continue
        rows = _noise(name, g)
        if rows is not None:
            for side in (g, w):
                assert np.abs(side[rows] - start[name][rows]).max() <= \
                    lr_sum * 1.001, (what, name)
            g, w = np.delete(g, rows), np.delete(w, rows)
        if np.isclose(g, w, rtol=RTOL, atol=RTOL).all():
            continue
        err = np.linalg.norm((g - w).astype(np.float64))
        assert err <= RTOL * np.linalg.norm(w.astype(np.float64)), \
            (what, name, err)
        assert np.abs(g - w).max() <= 2 * lr_sum * 1.001, (what, name)


def _batch(res, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((B, 77), np.int32)
    for r in range(B):
        length = int(rng.integers(5, 40))
        toks[r, 0], toks[r, length - 1] = SOT, EOT
        toks[r, 1:length - 1] = rng.integers(1, SOT, size=length - 2)
    # base + two strong views, each noise around a colour of its own
    images = rng.normal(size=(B, res, res, 9)) + rng.normal(size=(B, 1, 1, 9))
    return {"images": images.astype(np.float32), "tokens": toks}


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "tokens": torch.from_numpy(batch["tokens"]).long()}


def _cfg(weights):
    return {"loss_weight": dict(weights),
            "grad_clip": {"type": "logit_scale_param_value", "value": 3,
                          "max_value": 6}}


def _port(cfg, variables):
    port = model_entry(cfg)
    port.load_state_dict(state_from_jax_variables(variables), strict=True)
    return port.train()


def _tiny_loss_cfg(cfg):
    return {"loss_weight": dict(cfg.loss_weight),
            "grad_clip": dict(cfg.grad_clip)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side, from the port's seeded init, in two compiles. The
    first: both models' {name: (feature dict, the training forward's
    batch_stats, [(total, metrics) per WEIGHTS])}. The second, under
    "trajectory": tiny_slip's ``_jax_trajectory``, whose first gradient
    the gradient test reads (the ResNet's gradients are left to the
    DeCLIP-R50 tests, tests/test_torch_declip.py: SLIP adds no layer to the
    tower, and its head is the ViT's). Also the variables and the batch."""
    models = {n: jax_model_entry(c) for n, c in MODELS.items()}
    variables = {n: _seeded_variables(c) for n, c in MODELS.items()}
    batch = _batch(RES, 1)

    def run(variables):
        res = {}
        for name, jmodel in models.items():
            o, mutated = jmodel.apply(variables[name], batch, train=True,
                                      mutable=["batch_stats"])
            res[name] = (o, mutated["batch_stats"],
                         [jax_slip_losses(o, _cfg(w), None)
                          for w in WEIGHTS])
        return res

    res = jax.device_get(jax.jit(run)(variables))
    cfg, mcfg, ema = _tiny(TINY)
    tiny_batch = _batch(mcfg["kwargs"]["image_encode"]["input_resolution"])
    res["trajectory"] = {
        **_jax_trajectory(mcfg, _tiny_loss_cfg(cfg), ema, tiny_batch),
        "batch": tiny_batch}
    return {"variables": variables, "batch": batch, **res}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_losses_match_jax(jax_runs, name):
    want, stats, jterms = jax_runs[name]
    port = _port(MODELS[name], jax_runs["variables"][name])
    assert isinstance(port, SLIP) and method_of(port) == "slip"
    got = port(_torch_batch(jax_runs["batch"]))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].detach().numpy()
        assert g.shape == np.shape(w), key
        _close(g, w, key)

    # each BatchNorm's statistics after the forward, chained call to call
    want_stats = state_from_jax_variables({"batch_stats": stats})
    bns = {n: m for n, m in port.named_modules() if isinstance(m, BatchNorm)}
    assert sorted(f"{n}.{s}" for n in bns
                  for s in ("running_mean", "running_var")) == \
        sorted(want_stats)
    for n, m in bns.items():
        assert m.pending is not None, n
        for s, t in zip(("running_mean", "running_var"), m.pending):
            np.testing.assert_allclose(
                t.numpy(), want_stats[f"{n}.{s}"].numpy(), rtol=1e-5,
                atol=1e-6, err_msg=f"{n}.{s}")
    assert not np.allclose(want_stats["predictor_sim.bn1.running_var"], 1.0)

    for weights, (jtotal, jmetrics) in zip(WEIGHTS, jterms):
        total, metrics = make_losses_from_out(_cfg(weights), "slip")(
            port, None, got)
        assert sorted(metrics) == sorted(jmetrics)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=RTOL, err_msg=str(weights))
        for key, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(v), rtol=RTOL, atol=1e-6,
                                       err_msg=f"{weights} {key}")


def test_gradients_match_jax(jax_runs):
    """Every parameter's gradient of tiny_slip's loss at its trajectory's
    first step, against the gradient JAX's train step took there. Those
    that are 0 in exact arithmetic (predictor_sim's biases before a
    BatchNorm, the key rows of ``in_proj_bias``) are rounding noise on both
    sides, each held to 1e-4 of the norm of its layer's other gradient, as
    chip_smoke.py's fp32 steps hold them."""
    traj = jax_runs["trajectory"]
    cfg, mcfg, _ = _tiny(TINY)
    want = state_from_jax_variables({"params": traj["grads"]})
    port = _port(mcfg, traj["variables"])
    named = dict(port.named_parameters())
    total, _ = make_losses_from_out(_tiny_loss_cfg(cfg), "slip")(
        port, None, port(_torch_batch(traj["batch"])))
    np.testing.assert_allclose(float(total.detach()),
                               traj["hist"][0]["loss"], rtol=RTOL)
    got = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    assert sorted(want) == sorted(named)
    for pname in named:
        g, w = got[pname].numpy(), want[pname].numpy()
        rows = _noise(pname, g)
        if rows is not None:  # rounding noise on both sides
            if rows == slice(None):
                other = got[pname.replace(".bias", ".weight")].numpy()
            else:
                other = np.delete(g, rows)
            for side in (g, w):
                assert np.linalg.norm(side[rows]) <= \
                    1e-4 * np.linalg.norm(other), pname
            g, w = np.delete(g, rows), np.delete(w, rows)
        _close(g, w, pname, rtol=1e-3)


OFFSETS = (0, 8)


def _nt_xent_losses(gz, offset, lib, cast):
    """``nt_xent`` on the local batch (temperatures 0.5 and 0.1), and
    ``nt_xent_gather`` with this shard's 8 rows at ``offset`` in a gathered
    batch of 24 (the labels rank * B + arange(B))."""
    gi, gj = cast(gz[0]), cast(gz[1])
    zi, zj = gi[offset:offset + B], gj[offset:offset + B]
    labels = lib.arange(B) + offset
    return [lib.nt_xent(zi, zj, 0.5), lib.nt_xent(zi, zj, 0.1),
            lib.nt_xent_gather(zi, gi, zj, gj, labels, 0.1)]


def _nt_xent_inputs(offset):
    return np.random.default_rng(offset).normal(
        size=(2, 24, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_nt_xent():
    """JAX's losses for every offset, in fp32 and bf16, in one compile."""
    class Jax:
        arange = staticmethod(jnp.arange)
        nt_xent = staticmethod(jax_losses_mod.nt_xent)
        nt_xent_gather = staticmethod(jax_losses_mod.nt_xent_gather)

    gzs = [_nt_xent_inputs(o) for o in OFFSETS]
    return jax.device_get(jax.jit(lambda gzs: {
        o: [_nt_xent_losses(gz, o, Jax, lambda a: a.astype(dt))
            for dt in (jnp.float32, jnp.bfloat16)]
        for o, gz in zip(OFFSETS, gzs)})(gzs))


@pytest.mark.parametrize("offset", OFFSETS)
def test_nt_xent_matches_jax(jax_nt_xent, offset):
    """``nt_xent`` and ``nt_xent_gather`` (``_nt_xent_losses``) on fp32
    and bf16 features (rtol 1e-4 and 1e-2)."""
    class Port:
        arange = staticmethod(torch.arange)
        nt_xent = staticmethod(nt_xent)
        nt_xent_gather = staticmethod(nt_xent_gather)

    gz = torch.from_numpy(_nt_xent_inputs(offset))
    for (dtype, rtol), w in zip(((torch.float32, RTOL),
                                 (torch.bfloat16, 1e-2)),
                                jax_nt_xent[offset]):
        got = _nt_xent_losses(gz, offset, Port, lambda a: a.to(dtype))
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(x) for x in w], rtol=rtol,
                                   err_msg=str(dtype))


def test_trajectory_of_tiny_slip_matches_jax(jax_runs):
    """experiments/unit/tiny_slip's model, loss weights, guard and EMA
    decay, with tests/test_torch_declip.py's AdamW and schedule, four steps
    on one batch; the BatchNorm statistics of ``predictor_sim`` included."""
    traj = jax_runs["trajectory"]
    cfg, mcfg, ema = _tiny(TINY)
    jhist, jstate = traj["hist"], traj["state"]
    port, state, hist, start = _port_trajectory(
        mcfg, _tiny_loss_cfg(cfg), ema, traj["variables"],
        _torch_batch(traj["batch"]))
    for i, (metrics, want) in enumerate(zip(hist, jhist)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, err_msg=f"step {i} {key}")
        for key in ("clip_loss", "simclr_loss", "top1", "top5",
                    "logit_scale", "lr"):
            np.testing.assert_allclose(float(metrics[key]), want[key],
                                       rtol=RTOL, atol=RTOL,
                                       err_msg=f"step {i} {key}")
        assert metrics["update_skipped"] == want["update_skipped"] == 0.0
    lr_sum = sum(h["lr"] for h in jhist)
    final = {n: t.numpy() for n, t in state_from_jax_variables(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    got = {n: t.detach().numpy() for n, t in port.state_dict().items()}
    assert sorted(got) == sorted(final)
    assert not np.allclose(got["predictor_sim.bn1.running_var"], 1.0)
    _assert_state_close(got, final, {**start, **{n: got[n] for n in got
                                                 if n not in start}},
                        lr_sum, "state")
    shadow = state_from_jax_variables({"params": jstate.ema_params})
    _assert_state_close({n: e.numpy() for n, e in state.ema_params.items()},
                        {n: t.numpy() for n, t in shadow.items()},
                        {n: np.zeros_like(a) for n, a in start.items()},
                        lr_sum, "ema")
