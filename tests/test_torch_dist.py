"""The port's data-parallel training on two gloo ranks of this CPU, against
the JAX package.

One module-scoped launch (``torch_dist_cases.spawn``: a free port, a 60 s
init timeout, a 120 s join deadline that kills the ranks and fails the
test) runs every case of tests/torch_dist_cases.py on both
ranks and returns the results; the JAX references are computed here
after it. Each rank holds the contiguous half of every global batch, as
the JAX solver lays the global batch over its data axis.

- The global-batch losses (``clip_pair_loss``, SLIP's ``nt_xent_gather``,
  DeCLIP's NN-text term, FILIP's dense term through the late
  interaction's plain versions, and the ``ring`` and ``sigmoid_ring`` loss
  kinds, whose blocks move by the differentiable shift, the latter with a
  SigLIP bias): the mean of the ranks' losses, and each
  rank's gradient with respect to its own features over the world size,
  against JAX's shard_map mode on a 2-device mesh (its loss ``pmean``-ed,
  its gradient that of the mean), rtol 1e-5 and atol 1e-6; DeCLIP's
  ConVIRT term against JAX's on the global batch.
- The train step of each method at world 2 against JAX's step on the
  global batch, two steps (``two_steps``), from the trajectory tests'
  setups (their JAX runs are called as they call them, so that one JAX
  compile serves both files): CLIP (tests/test_torch_train.py's ``ema``
  case), SLIP and DeFILIP (experiments/unit/tiny_slip, tiny_defilip),
  FILIP with every term on (MLM included), DeCLIP-R50 with the NN bank and
  BatchNorm over the global batch and, with ``use_sync_bn: false``, over
  each rank's own rows (JAX: ``bn_world`` 2); the losses, metrics,
  parameters, EMA, bank and BatchNorm running statistics within those
  tests' fp32 tolerances (DeCLIP-R50's parameters as ``_declip_check``
  says), and the two ranks' states bit for bit equal.
- A NaN in rank 1's rows alone makes both ranks skip the step.
- The world-size factor: a gather whose backward keeps its own gradient
  without the sum over the ranks, and a gradient all-reduce that sums
  instead of averaging, each planted in the ranks once, fail the checks.
- The solver on experiments/unit/tiny_declip at world 2 (batch 4 a rank):
  three steps with saves at 2 and 3 and the zero-shot eval, against one
  process at batch 8 on the same global batches (the sampler's
  ``orig_world_size``/``orig_batch_size``); the inputs fed so that no draw
  depends on the world (tests/torch_dist_cases.py: ``FedInputs``); the
  merged eval equals one process's; the step-2 checkpoint resumes at world
  1 (elastic resume) and ends where the world-2 run ended.
- A preemption signal that reaches rank 1 alone stops both ranks after the
  same step, and neither evaluates.

The ranks run alone first and the JAX references after them: a rank waits
at every collective for the other, so on a loaded host (the suite's other
workers) it loses most of its time to the scheduler, and the parent's own
JAX threads would add to that.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import concurrent.futures
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_cases
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

import test_torch_declip as tdeclip
import test_torch_defilip as tdefilip
import test_torch_filip as tfilip
import test_torch_slip as tslip
import test_torch_ssl as tssl
import test_torch_train as ttrain

from declip_tpu import losses as jax_losses
from declip_tpu.models import model_entry as jax_model_entry
from declip_tpu.models.clip_model import (
    resolve_bn_stats_groups as jax_resolve_bn_stats_groups,
)
from declip_tpu.models.memory_bank import init_bank as jax_init_bank
from declip_tpu.ops import contrastive as jax_contrastive
from declip_tpu.parallel.comms import group_split as jax_group_split
from declip_tpu.train import method_losses as jax_method_losses

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models.clip_model import resolve_bn_stats_groups
from declip_tpu_torch.parallel import comms
from declip_tpu_torch.parallel.dist import first_host, launch_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
RTOL = 1e-4  # the trajectory tests' fp32 tolerance
STEPS = 2
TINY_DECLIP = os.path.join(REPO, "experiments/unit/tiny_declip/config.yaml")


# ------------------------------------------------------------------ inputs
def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _loss_inputs():
    rng = np.random.default_rng(0)

    def feats(*shape):
        return _unit(rng.normal(size=shape))

    n, d = 8, 16
    return {
        "clip": {"img": feats(n, d), "txt": feats(n, d), "scale": 7.0},
        "ring": {"img": feats(n, d), "txt": feats(n, d), "scale": 7.0},
        "sigmoid_ring": {"img": feats(n, d), "txt": feats(n, d),
                         "scale": 7.0, "bias": -3.0},
        "nt_xent": {"z_i": feats(n, d), "z_j": feats(n, d)},
        "convirt": {"z_i": feats(n, d), "z_j": feats(n, d)},
        "nn_text": {"i1": feats(n, d), "i2": feats(n, d), "t": feats(n, d),
                    "ta": feats(n, d), "nn": feats(n, d),
                    "nn_aug": feats(n, d), "scale": 5.0},
        "filip": {"img": feats(n, d), "txt": feats(n, d),
                  "di": feats(n, 5, d), "dt": feats(n, 6, d),
                  "di_sel": feats(n, 3, d), "dt_sel": feats(n, 3, d),
                  "scale": 4.0},
    }


def _jax_loss(name, x, axis):
    """The JAX package's loss ``name`` over ``axis`` (None: the global
    batch)."""
    scale = jnp.asarray(x.get("scale", 1.0), jnp.float32)
    if name == "clip":
        return jax_contrastive.clip_pair_loss(x["img"], x["txt"], scale,
                                              axis)[0]
    if name in ("ring", "sigmoid_ring"):
        bias = jnp.asarray(x.get("bias", 0.0), jnp.float32)
        if axis is None:  # the global batch's: the full kind
            full = {"ring": "full", "sigmoid_ring": "sigmoid"}[name]
            return jax_contrastive.make_pair_loss(
                {"loss_impl": full})(x["img"], x["txt"], (scale, bias))[0]
        return jax_contrastive.make_pair_loss(
            {"loss_impl": name}, axis_name=axis)(
                x["img"], x["txt"], (scale, bias))[0]
    if name == "nt_xent":
        zi, zj = x["z_i"], x["z_j"]
        labels = jax_contrastive.infonce_labels(zi.shape[0], axis)
        return jax_losses.nt_xent_gather(
            zi, jax_contrastive.gather_features(zi, axis), zj,
            jax_contrastive.gather_features(zj, axis), labels, 0.1)
    if name == "convirt":  # JAX's is the global batch's, as its solver
        return jax_losses.nt_xent_convirt(x["z_i"], x["z_j"])
    if name == "nn_text":
        out = {"image_embed_1": x["i1"], "image_embed_2": x["i2"],
               "text_embed": x["t"], "text_embed_aug": x["ta"],
               "logit_scale": scale,
               "simsiam": (x["i1"], x["i2"], x["i2"], x["i1"])}
        return jax_method_losses.declip_losses(
            out, {"clip_simsiam_loss_weight": {"nn_text": 1.0}}, axis,
            nn_text=(x["nn"],), nn_text_aug=(x["nn_aug"],))[1][
                "clip_nn_text_loss"]
    if name == "filip":
        out = {"image_embed": x["img"], "text_embed": x["txt"],
               "logit_scale": scale, "logit_scale_dense": scale,
               "dense_image": x["di"], "dense_text": x["dt"],
               "dense_image_sel": x["di_sel"], "dense_text_sel": x["dt_sel"]}
        return jax_method_losses.filip_losses(
            out, {"clip_simsiam_loss_weight": {"clip_dense_loss": 1.0},
                  "filip_dense": {"impl": "xla"}}, axis)[1]["clip_dense_loss"]
    raise KeyError(name)


def _jax_shard_map(name, inputs):
    """(loss, {input: gradient}, the global batch's loss) of the ranks' mean
    loss under shard_map on a 2-device mesh, each input's rows split over
    the devices, in one compile; ConVIRT's JAX loss takes no axis, so its
    reference is the global batch's."""
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    keys = [k for k in inputs if k not in ("scale", "bias")]
    argnums = tuple(range(len(keys)))

    def loss_of(xs, axis):
        x = dict(zip(keys, xs), scale=inputs.get("scale", 1.0),
                 bias=inputs.get("bias", 0.0))
        return _jax_loss(name, x, axis)

    if name == "convirt":
        def fn(*xs):
            loss, grads = jax.value_and_grad(
                lambda *ys: loss_of(ys, None), argnums=argnums)(*xs)
            return loss, grads, loss
    else:
        def body(*xs):
            return jax.value_and_grad(
                lambda *ys: jax.lax.pmean(loss_of(ys, "data"), "data"),
                argnums=argnums)(*xs)

        sharded = shard_map(body, mesh=mesh,
                            in_specs=(P("data"),) * len(keys),
                            out_specs=(P(), (P("data"),) * len(keys)))

        def fn(*xs):
            return (*sharded(*xs), loss_of(xs, None))

    loss, grads, whole = jax.jit(fn)(*[jnp.asarray(inputs[k]) for k in keys])
    return (float(loss), {k: np.asarray(g) for k, g in zip(keys, grads)},
            float(whole))


# ------------------------------------------------------------------- steps
def _state(variables):
    return {k: v.numpy() for k, v in state_from_jax_variables(
        dict(variables)).items()}


def _with_image_encode(cfg, **extra):
    kwargs = dict(cfg["kwargs"])
    kwargs["image_encode"] = {**kwargs["image_encode"], **extra}
    return {"type": cfg["type"], "kwargs": kwargs}


def _step_specs():
    """{case: (the ranks' trajectory spec, the JAX run's thunk)}."""
    specs = {}
    common = {"opt": tdeclip.OPT, "pconfig": tdeclip.PCONFIG,
              "sched": tdeclip.SCHED, "max_iter": tdeclip.MAX_ITER,
              "steps": STEPS}

    # CLIP: tests/test_torch_train.py's "ema" case
    grad_clip, ema = ttrain.CASES["ema"]
    cfg = ttrain._model_cfg()
    variables = tdefilip._seeded_variables(cfg)
    batch = ttrain._batch()
    specs["clip"] = (
        {**common, "opt": ttrain.OPT, "pconfig": ttrain.PCONFIG,
         "sched": ttrain.SCHED, "model": cfg, "state": _state(variables),
         "loss_cfg": {"grad_clip": grad_clip}, "ema": ema, "batch": batch},
        lambda cfg=cfg, variables=variables, batch=batch, ema=ema:
        ttrain._run_jax(jax_model_entry(cfg), variables["params"],
                        grad_clip, ema, STEPS, batch))

    # FILIP with every term on
    cfg = tfilip.MODEL_CFG
    variables = tdefilip._seeded_variables(cfg)
    batch = tfilip._batch()
    loss_cfg = tfilip._cfg(tfilip.ALL_ON)
    specs["filip"] = (
        {**common, "opt": tfilip.OPT, "pconfig": tfilip.PCONFIG,
         "sched": tfilip.SCHED, "model": cfg, "state": _state(variables),
         "loss_cfg": loss_cfg, "ema": None, "batch": batch},
        lambda cfg=cfg, variables=variables, batch=batch, loss_cfg=loss_cfg:
        tfilip._run_jax(jax_model_entry(cfg), variables["params"], loss_cfg,
                        batch))

    # DeCLIP-R50 of tests/test_torch_declip.py: BatchNorm over the global
    # batch, and with the tower's use_sync_bn: false over each rank's rows
    # (JAX: two batch groups over the global batch); one set of weights
    base = tdeclip.MODELS["res50"][0]
    variables = tdefilip._seeded_variables(base)
    jbank = jax_init_bank(jax.random.PRNGKey(1), tdeclip.BANK, 64)
    batch = tdeclip._batch(tdeclip.MODELS["res50"][1])
    for name, cfg, jcfg in (
            ("declip", base, base),
            ("declip_per_rank_bn", _with_image_encode(base, use_sync_bn=False),
             _with_image_encode(base, use_sync_bn=False, bn_world=WORLD))):
        specs[name] = (
            {**common, "model": cfg, "state": _state(variables),
             "loss_cfg": tdeclip._cfg("res50"), "ema": None,
             "bank": (np.asarray(jbank.bank), int(jbank.ptr)),
             "batch": batch},
            lambda jcfg=jcfg, variables=variables, jbank=jbank,
            batch=batch: tdeclip._run_jax(
                "res50", jax_model_entry(jcfg), variables, jbank, batch))

    # SLIP and DeFILIP: the experiments/unit recipes
    for name, mod, bank in (("slip", tslip, False),
                            ("defilip", tdefilip, True)):
        cfg, mcfg, ema = tdefilip._tiny(mod.TINY)
        loss_cfg = mod._tiny_loss_cfg(cfg)
        batch = tdeclip._batch(mcfg["kwargs"]["image_encode"][
            "input_resolution"])
        if name == "slip":
            batch = tslip._batch(mcfg["kwargs"]["image_encode"][
                "input_resolution"])
        tbank = None
        if bank:
            tbank = jax_init_bank(
                jax.random.PRNGKey(1), int(mcfg["kwargs"]["clip"]["nn_size"]),
                int(mcfg["kwargs"]["clip"]["feature_dim"]))
        variables = tdefilip._seeded_variables(mcfg)
        specs[name] = (
            {**common, "model": mcfg, "state": _state(variables),
             "loss_cfg": loss_cfg, "ema": ema, "batch": batch,
             "bank": None if tbank is None else (np.asarray(tbank.bank),
                                                 int(tbank.ptr))},
            lambda mcfg=mcfg, loss_cfg=loss_cfg, ema=ema, batch=batch,
            tbank=tbank: _trajectory_as_run(tdefilip._jax_trajectory(
                mcfg, loss_cfg, ema, batch, tbank)))
    return specs


def _ssl_spec():
    """moco_res50 at tests/test_torch_ssl.py's widths, two steps on global
    batches of 2 x 4 rows, K 64: each step enqueues both ranks' keys."""
    model = tssl._moco()
    queue = _unit(np.random.default_rng(1).normal(size=(tssl.K, tssl.DIM)))
    return {"model": tssl._cfg("moco_res50"), "opt": tssl.OPT,
            "sched": tssl.SCHED, "max_iter": tssl.MAX_ITER,
            "state": {k: v.numpy() for k, v in model.state_dict().items()},
            "queue": queue,
            "batches": [tssl._batch("moco_res50", i) for i in range(STEPS)]}


def _trajectory_as_run(traj):
    return traj["state"], traj["hist"]


def _solver_experiment(root, name, sets):
    exp = os.path.join(root, name)
    os.makedirs(exp, exist_ok=True)
    shutil.copy(TINY_DECLIP, os.path.join(exp, "config.yaml"))
    # SimSiam's weight 0 (the term still runs): its head's BatchNorm over
    # the synthetic set's nearly equal rows amplifies rounding into the
    # whole model within a few steps; the step test above holds SimSiam at
    # world 2 to JAX. No EMA: the step tests hold it. No EDA: the fed
    # inputs replace its captions (and it imports nltk, seconds a rank).
    base = ["lr_scheduler.kwargs.max_iter=3", "saver.print_freq=1",
            "saver.save_freq=2", "saver.val_freq=0",
            "data.train.num_workers=1", "ema.enable=false",
            "model.kwargs.clip.EDA=false",
            "clip_simsiam_loss_weight.simsiam_loss=0"]
    return os.path.join(exp, "config.yaml"), base + sets


# ------------------------------------------------------------------ launch
@pytest.fixture(scope="module")
def two_steps():
    """The trajectory tests' runs and checks at STEPS = 2 for this module:
    over four steps Adam's normalised updates carry fp32 rounding of the
    near-zero gradients into the metrics (the one-process port's DeCLIP
    grad_norm is 9.5e-5 from JAX's at step 4 and 5e-6 at step 2), and
    the ranks' gathers and all-reduces round otherwise than one process."""
    mods = (tdeclip, tdefilip, tfilip, tslip, ttrain)
    saved = [m.STEPS for m in mods]
    for m in mods:
        m.STEPS = STEPS
    yield
    for m, n in zip(mods, saved):
        m.STEPS = n


@pytest.fixture(scope="module")
def runs(tmp_path_factory, two_steps):
    """{"ranks": each rank's results, "jax": {case: (state, history)},
    "losses": {name: JAX's (loss, grads)}, "solver_dir"}."""
    root = str(tmp_path_factory.mktemp("dist"))
    losses = _loss_inputs()
    steps = _step_specs()
    spec = {"losses": losses,
            "steps": {k: s for k, (s, _) in steps.items()},
            "ssl": _ssl_spec(),
            "solver": _solver_experiment(root, "world2", []),
            "preempted": _solver_experiment(root, "preempted", [])}
    ranks = torch_dist_cases.spawn(torch_dist_cases.run, WORLD,
                                   args=(spec,), timeout_s=120)
    # the JAX runs on threads of their own: XLA's compiles release the GIL
    # that the other runs' tracing holds
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs_ = {k: pool.submit(lambda run=run: jax.device_get(run()))
                 for k, (_, run) in steps.items()}
        jax_losses_ = {name: _jax_shard_map(name, x)
                       for name, x in losses.items()}
        jax_runs = {k: f.result() for k, f in runs_.items()}
    return {"ranks": ranks, "jax": jax_runs, "losses": jax_losses_,
            "inputs": losses, "specs": spec["steps"], "root": root,
            "ssl": torch_dist_cases.ssl_trajectory(spec["ssl"], None)}


# ------------------------------------------------------------------ losses
def _check_loss(name, ranks, want):
    loss = np.mean([r["loss"] for r in ranks])
    np.testing.assert_allclose(loss, want[0], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL, err_msg=f"{name} loss")
    for key, g in want[1].items():
        # an input the loss does not reach has no gradient in the port
        got = np.concatenate([r["grads"].get(key, np.zeros_like(g[:1]))
                              * np.ones((len(g) // WORLD,) + g.shape[1:])
                              for r in ranks]) / WORLD
        np.testing.assert_allclose(got, g, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"{name} d/d{key}")


@pytest.mark.parametrize("name", ["clip", "nt_xent", "convirt", "nn_text",
                                  "filip", "ring", "sigmoid_ring"])
def test_loss_matches_jax_shard_map(runs, name):
    _check_loss(name, [r["losses"][name] for r in runs["ranks"]],
                runs["losses"][name])


def test_shard_map_mode_is_the_global_loss(runs):
    """The yardstick itself: JAX's shard_map loss is its global one."""
    for name, (loss, _, whole) in runs["losses"].items():
        np.testing.assert_allclose(whole, loss, rtol=LOSS_RTOL,
                                   err_msg=name)


def test_gather_without_the_sum_fails(runs):
    with pytest.raises(AssertionError):
        _check_loss("clip", [r["forgetful_gather"] for r in runs["ranks"]],
                    runs["losses"]["clip"])


# ------------------------------------------------------------------- steps
def _check_history(hist, jhist, name):
    for i, (got, want) in enumerate(zip(hist, jhist)):
        assert got["update_skipped"] == want["update_skipped"] == 0.0
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=f"{name} step {i} {key}")
        for key, w in want.items():
            if key in got and key not in ("update_skipped",
                                          "logit_clip_count"):
                np.testing.assert_allclose(
                    got[key], w, rtol=RTOL, atol=RTOL,
                    err_msg=f"{name} step {i} {key}")
    assert len(hist) == len(jhist)


# DeCLIP-R50's SimSiam projector takes BatchNorm over nearly equal rows,
# which amplifies rounding: image features 5e-7 apart between the ranks and
# one process give projections 2.5e-5 apart (2.5e-6 and 5.8e-5 between the
# one-process port and JAX), and the first gradient of the tower then
# differs by up to 5e-4 of its norm (1e-5 with the SimSiam terms at weight
# 0). Adam's normalised steps carry that into single elements, of the
# zero-initialised bn3 scales too. So what the steps moved is held as a
# whole: ||(got - start) - (want - start)|| within DELTA_RTOL of
# ||want - start||, over every parameter but those whose gradient is 0 in
# exact arithmetic (tests/test_torch_declip.py's ZERO_GRAD, each within
# Adam's bound of its start on both sides), and no element further from the
# other side's than two Adam paths (2 lr_sum); the BatchNorm statistics
# element by element, as there. Measured on this CPU: 2.8e-3 with the
# global moments, 1.1e-4 with each rank's. Planted in the ranks, a gather
# whose backward forgets the sum over the ranks gives 0.74; a gradient
# all-reduce that sums gives 4.2e-3, since Adam's update does not see the
# gradient's scale: the history's grad_norm catches that one
# (test_summing_all_reduce_fails).
DELTA_RTOL = 1e-2


def _declip_check(got, want, start, lr_sum, what):
    err = moved = 0.0
    for name, g in got.items():
        w, s = want[name], start[name]
        if name.endswith(("running_mean", "running_var")):
            tdeclip._assert_close({name: g}, {name: w}, start, lr_sum, what)
            continue
        rows = tdeclip._noise_slice(name, g)
        if rows is not None:
            for side in (g, w):
                assert np.abs(side[rows] - s[rows]).max() <= \
                    lr_sum * 1.001, (what, name)
            g, w, s = (np.delete(a, rows) for a in (g, w, s))
        assert np.abs(g - w).max(initial=0.0) <= 2 * lr_sum * 1.001, \
            (what, name)
        g, w, s = (a.astype(np.float64) for a in (g, w, s))
        err += float(((g - w) ** 2).sum())  # (g - s) - (w - s)
        moved += float(((w - s) ** 2).sum())
    assert err ** 0.5 <= DELTA_RTOL * moved ** 0.5, \
        (what, (err / moved) ** 0.5)


# each case's state check, as its trajectory test holds it
CHECKS = {"clip": ttrain._assert_params_close,
          "filip": ttrain._assert_params_close,
          "declip": _declip_check, "declip_per_rank_bn": _declip_check,
          "slip": tslip._assert_state_close,
          "defilip": tdeclip._assert_close}


@pytest.mark.parametrize("name", list(CHECKS))
def test_train_step_at_world_2_matches_jax(runs, name):
    r0, r1 = (r["steps"][name] for r in runs["ranks"])
    for key in r0["state"]:  # the ranks hold one state
        np.testing.assert_array_equal(r0["state"][key], r1["state"][key],
                                      err_msg=key)
    assert r0["hist"] == r1["hist"]
    jstate, jhist = runs["jax"][name]
    _check_history(r0["hist"], jhist, name)
    spec = runs["specs"][name]
    lr_sum = sum(h["lr"] for h in jhist)
    jvars = {"params": jstate.params}
    if getattr(jstate, "batch_stats", None):
        jvars["batch_stats"] = jstate.batch_stats
    final = _state(jvars)
    got = {k: v for k, v in r0["state"].items() if k in final}
    assert sorted(got) == sorted(final)
    check = CHECKS[name]
    check(got, final, spec["state"], lr_sum, f"{name} state")
    if r0["ema"] is not None:
        shadow = _state({"params": jstate.ema_params})
        check(r0["ema"], shadow,
                     {n: np.zeros_like(a) for n, a in r0["ema"].items()},
                     lr_sum, f"{name} ema")
    if r0["bank"] is not None:
        assert r0["ptr"] == int(jstate.bank_text.ptr)
        np.testing.assert_allclose(r0["bank"],
                                   np.asarray(jstate.bank_text.bank),
                                   rtol=RTOL, atol=1e-5)
        np.testing.assert_array_equal(r0["bank"], r1["bank"])
    if r0["guard"] is not None:
        np.testing.assert_allclose(r0["guard"],
                                   float(jstate.logit_ema_buffer), rtol=RTOL)


def test_bn_running_statistics_take_the_global_moments(runs):
    """The per-rank BatchNorm normalises with each rank's moments and still
    moves the running statistics by the global ones: both ranks hold the
    same, and they differ from the global-moment run's only through the
    weights the two runs took."""
    per_rank = [r["steps"]["declip_per_rank_bn"]["state"]
                for r in runs["ranks"]]
    glob = runs["ranks"][0]["steps"]["declip"]["state"]
    stats = [k for k in per_rank[0] if k.startswith("visual.")
             and k.endswith("running_var")]
    assert stats
    for k in stats:
        np.testing.assert_array_equal(per_rank[0][k], per_rank[1][k])
    assert any(not np.allclose(per_rank[0][k], glob[k], rtol=1e-6)
               for k in stats)


def test_summing_all_reduce_fails(runs):
    jstate, jhist = runs["jax"]["clip"]
    with pytest.raises(AssertionError):
        _check_history(runs["ranks"][0]["summing"]["hist"], jhist, "clip")


def test_nan_on_one_rank_skips_the_step_everywhere(runs):
    for r in runs["ranks"]:
        assert r["poisoned"] == {"skipped": 1.0, "unchanged": True}


# ------------------------------------------------------------------ solver
@pytest.fixture(scope="module")
def world1(runs):
    """One process at twice the batch on the world-2 run's global batches,
    and the world-2 step-2 checkpoint resumed at world 1."""
    root = runs["root"]
    sampler = ('data.train.sampler={"type": "distributed_iteration", '
               '"kwargs": {"orig_world_size": 2, "orig_batch_size": 4}}')
    cfg, sets = _solver_experiment(root, "world1",
                                   ["data.train.batch_size=8", sampler])
    whole = torch_dist_cases.run_solver(cfg, sets)
    cfg_r, sets_r = _solver_experiment(root, "resumed",
                                       ["data.train.batch_size=8"])
    ckpts = os.path.join(os.path.dirname(cfg_r), "checkpoints")
    os.makedirs(ckpts)
    src = os.path.join(root, "world2", "checkpoints")
    for f in ("ckpt_2.pth.tar", "ckpt_meta.json"):
        shutil.copy(os.path.join(src, f), ckpts)
    resumed = torch_dist_cases.run_solver(cfg_r, sets_r)
    return whole, resumed


def _close_states(got, want, run, what):
    """As tests/test_torch_slip.py holds its four-step states (rtol and atol
    1e-4, or a tensor within 1e-4 of its norm with no element further than
    two Adam paths apart; the parameters whose gradient is 0 in exact
    arithmetic within Adam's step bound of their start)."""
    lr_sum = sum(run["lr"].values())
    tslip._assert_state_close(got, want, run["start"], lr_sum, what)


def test_solver_at_world_2_matches_one_process(runs, world1):
    whole, _ = world1
    r0, r1 = (r["solver"] for r in runs["ranks"])
    assert sorted(r0["losses"]) == [1, 2, 3] and not r1["losses"]
    for step, loss in whole["losses"].items():
        np.testing.assert_allclose(r0["losses"][step], loss, rtol=RTOL,
                                   err_msg=f"step {step}")
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k])
    _close_states(r0["state"], whole["state"], whole, "world 2 vs 1")
    ckpts = sorted(os.listdir(os.path.join(runs["root"], "world2",
                                           "checkpoints")))
    assert ckpts == ["ckpt_2.pth.tar", "ckpt_3.pth.tar", "ckpt_meta.json"]


def test_merged_eval_equals_one_process(runs, world1):
    whole, _ = world1
    r0 = runs["ranks"][0]["solver"]["eval"]
    assert r0["n"] == whole["eval"]["n"] == 32
    assert (r0["top1"], r0["top5"]) == (whole["eval"]["top1"],
                                        whole["eval"]["top5"])


def test_preemption_on_one_rank_stops_every_rank(runs):
    """A signal that reaches rank 1 alone stops both ranks after the same
    step, with the final checkpoint and without the eval."""
    got = [r["preempted"] for r in runs["ranks"]]
    assert [(g["step"], g["evals"]) for g in got] == [(1, 0), (1, 0)]
    assert got[0]["ckpts"] == ["ckpt_1.pth.tar", "ckpt_meta.json"]


def test_world_2_checkpoint_resumes_at_world_1(runs, world1):
    """The sampler re-shards the world-2 stream: step 3 at world 1 sees the
    world-2 run's global batch and ends where it ended."""
    _, resumed = world1
    r0 = runs["ranks"][0]["solver"]
    assert sorted(resumed["losses"]) == [3]
    for step, loss in resumed["losses"].items():
        np.testing.assert_allclose(loss, r0["losses"][step], rtol=RTOL,
                                   err_msg=f"step {step}")
    _close_states(resumed["state"], r0["state"], r0, "resumed")


# ---------------------------------------------------------- no spawn needed
@pytest.mark.parametrize("world", [1, 2, 4, 6, 8, 32])
def test_resolve_bn_stats_groups_matches_jax(world):
    for sync in (True, False):
        for size in (1, 2, 3, 4, 16):
            assert resolve_bn_stats_groups(
                world, use_sync_bn=sync, bn_group_size=size) == \
                jax_resolve_bn_stats_groups(world, use_sync_bn=sync,
                                            bn_group_size=size)


def test_group_split_matches_jax():
    for world, size in ((8, 2), (8, 8), (32, 16), (4, 1)):
        assert comms.group_split(world, size) == jax_group_split(world, size)
    with pytest.raises(ValueError):
        comms.group_split(6, 4)


def test_launch_env_reads_torchrun_and_slurm():
    assert launch_env({}) is None
    assert launch_env({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
                       "MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "1234"}) \
        == {"rank": 3, "world": 8, "local_rank": 1, "addr": "10.0.0.2",
            "port": 1234}
    assert launch_env({"SLURM_PROCID": "5", "SLURM_NTASKS": "16",
                       "SLURM_LOCALID": "5",
                       "SLURM_STEP_NODELIST": "gpu[07-08,11],cpu1"}) == \
        {"rank": 5, "world": 16, "local_rank": 5, "addr": "gpu07",
         "port": 29500}
    assert first_host("node3") == "node3"


def test_moco_step_at_world_2_matches_one_process(runs):
    """moco_res50 on two ranks of 4 rows against one process on the 8: the
    metrics, the parameters and BatchNorm statistics of both encoders
    (the query's and the key encoder's BatchNorms over the global batch),
    and the queue with both ranks' keys enqueued in rank order, on both
    ranks, within tests/test_torch_ssl.py's trajectory tolerance; the
    ranks' states bit for bit equal."""
    r0, r1 = (r["ssl"] for r in runs["ranks"])
    want = runs["ssl"]
    assert r0["hist"] == r1["hist"]
    assert r0["ptr"] == r1["ptr"] == want["ptr"] == STEPS * tssl.B
    for got in (r0, r1):
        for part in ("state", "key"):
            assert sorted(got[part]) == sorted(want[part])
            for k, w in want[part].items():
                np.testing.assert_array_equal(got[part][k], r1[part][k])
                tssl._param_close(got[part][k], w, f"{part} {k}")
        np.testing.assert_allclose(got["queue"], want["queue"],
                                   rtol=tssl.RTOL, atol=tssl.PARAM_ATOL)
    for got, w in zip(r0["hist"], want["hist"]):
        assert sorted(got) == sorted(w) and got["update_skipped"] == 0.0
        for k in w:
            np.testing.assert_allclose(got[k], w[k], rtol=tssl.RTOL,
                                       err_msg=k)
