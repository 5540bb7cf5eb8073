"""FSDP, expert parallelism and MoE's global routing at world 2, on two
gloo ranks of this CPU, against the JAX package's single-device step on
the global batch.

One module-scoped launch (``torch_dist_cases.spawn``, ``run_sharded``)
runs every rank case; each rank holds the contiguous half of each global
batch. The step cases start from tests/test_torch_moe.py's MoE CLIP (both
towers MoE, 4 experts, top-2, a capacity of 0.6 that drops tokens) and
take its three steps on ``test_torch_train._batch()``, and each is held
to the JAX trajectory that file computes (``jax_moe_clip_run``, once a
process), at the trajectory tests' fp32 tolerance (rtol 1e-4):

- ``fsdp``: ``parallelism: {fsdp: true}`` with parameters from 2^10
  elements sharded (the tiny widths leave few at the default 2^14), an
  EMA; each rank holds half of every sharded parameter, slot and shadow
  (the element counts); the EMA against one process's; a checkpoint at
  step 2, in the world-1 format, resumes here at world 1 and its third
  step lands where the world-2 run's did; one process's checkpoint
  restored into the shards at world 2; Adafactor's and LARS's
  per-leaf statistics over the shards, two steps against one process;
- ``moe``: MoE without expert parallelism: the routing, capacity and aux
  loss over the global batch (two ranks routing their own rows would
  drop other tokens);
- ``ep``: ``parallelism: {ep: 2}``: each rank holds two experts, the
  tokens travel by the differentiable all-to-all.

The solver at world 2 on experiments/unit/tiny_declip (two steps, a save,
the zero-shot eval) with each key: ``fsdp: true`` against the same run
without it (losses and final weights), and ``ep: 2`` with MoE towers
(finite losses, ``moe_aux_loss`` logged, a checkpoint in the world-1
format, the eval). The JAX references run after the ranks, as in
tests/test_torch_dist.py.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import os
import shutil

import numpy as np
import pytest
import torch
import torch_dist_cases

import test_torch_moe as tmoe
import test_torch_train as ttrain

from declip_tpu_torch.checkpoint import restore_checkpoint
from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DECLIP = os.path.join(REPO, "experiments/unit/tiny_declip/config.yaml")
WORLD = 2
MIN_SIZE = 2 ** 10
EMA = (0.99, 1, 1, False)
RTOL = ttrain.RTOL


def _step_spec(**extra):
    cfg, _, params = tmoe.jax_moe_clip()
    state = {k: v.numpy() for k, v in
             state_from_jax_variables({"params": params}).items()}
    return {"model": cfg, "state": state, "opt": ttrain.OPT,
            "pconfig": ttrain.PCONFIG, "sched": ttrain.SCHED,
            "max_iter": ttrain.MAX_ITER, "steps": tmoe.STEPS,
            "loss_cfg": {"grad_clip": tmoe.GRAD_CLIP}, "ema": None,
            "batch": ttrain._batch(), **extra}


def _solver_experiment(root, name, sets):
    exp = os.path.join(root, name)
    os.makedirs(exp, exist_ok=True)
    shutil.copy(TINY_DECLIP, os.path.join(exp, "config.yaml"))
    base = ["lr_scheduler.kwargs.max_iter=2", "saver.print_freq=1",
            "saver.save_freq=2", "saver.val_freq=0",
            "data.train.num_workers=1", "ema.enable=false",
            "model.kwargs.clip.EDA=false",
            "clip_simsiam_loss_weight.simsiam_loss=0"]
    return os.path.join(exp, "config.yaml"), base + sets


# the rules whose statistics are per JAX leaf: Adafactor (factoring
# forced) and LARS, over FSDP's shards
LEAF_RULES = {
    "Adafactor": {"type": "Adafactor", "kwargs": {
        "lr": 0.001, "weight_decay": 0.0001, "min_dim_size_to_factor": 2,
        "momentum": 0.9}},
    "LARS": {"type": "LARS", "kwargs": {"lr": 0.1, "weight_decay": 0.1,
                                        "momentum": 0.9}}}
MOE_TOWERS = ['model.kwargs.image_encode.moe={"num_experts": 4}',
              'model.kwargs.text_encode.moe={"num_experts": 4}']


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsdp_ep"))
    ckpt = os.path.join(root, "fsdp_ckpt")
    # one process's step-1 checkpoint, which the FSDP ranks resume from
    one_ckpt = os.path.join(root, "one_ckpt")
    torch_dist_cases.trajectory(_step_spec(steps=1, ema=EMA, ckpt=one_ckpt,
                                           ckpt_step=1), None)
    resume = os.path.join(one_ckpt, "ckpt.pth.tar")
    spec = {
        "steps": {
            "fsdp": _step_spec(fsdp=True, min_size=MIN_SIZE,
                               ema=EMA, ckpt=ckpt, ckpt_step=2),
            "moe": _step_spec(),
            "ep": _step_spec(ep=WORLD),
            **{f"fsdp_{name}": _step_spec(fsdp=True, min_size=MIN_SIZE,
                                          opt=opt, steps=2)
               for name, opt in LEAF_RULES.items()},
            "fsdp_resume": _step_spec(fsdp=True, min_size=MIN_SIZE, ema=EMA,
                                      resume=resume, steps=2)},
        "solver": {
            "plain": _solver_experiment(root, "plain", []),
            "fsdp": _solver_experiment(root, "fsdp",
                                       ["parallelism.fsdp=true"]),
            "ep": _solver_experiment(root, "ep", ["parallelism.ep=2"]
                                     + MOE_TOWERS)}}
    ranks = torch_dist_cases.spawn(torch_dist_cases.run_sharded, WORLD,
                                   args=(spec,), timeout_s=150)
    jstate, jhist = tmoe.jax_moe_clip_run()
    return {"ranks": ranks, "spec": spec, "ckpt": ckpt, "root": root,
            "jax": (jstate, jhist)}


def _final(jstate):
    return {n: t.numpy() for n, t in state_from_jax_variables(
        {"params": jstate.params}).items()}


@pytest.mark.parametrize("case", ["fsdp", "moe", "ep"])
def test_world_2_step_matches_jax_on_the_global_batch(runs, case):
    jstate, jhist = runs["jax"]
    r0, r1 = (r["steps"][case] for r in runs["ranks"])
    for i, want in enumerate(jhist):
        for r in (r0, r1):
            got = r["hist"][i]
            assert got["update_skipped"] == 0.0
            for key in ("loss", "grad_norm", "moe_aux_loss", "clip_loss",
                        "logit_scale"):
                np.testing.assert_allclose(
                    got[key], want[key], rtol=RTOL,
                    err_msg=f"{case} step {i} {key}")
    for key in r0["state"]:  # the ranks hold one (gathered) state
        np.testing.assert_array_equal(r0["state"][key], r1["state"][key],
                                      err_msg=key)
    spec = runs["spec"]["steps"][case]
    start = {k: v for k, v in spec["state"].items()}
    lr_sum = sum(h["lr"] for h in jhist)
    params = {k: v for k, v in r0["state"].items() if k in start}
    ttrain._assert_params_close(params, _final(jstate), start, lr_sum,
                                case)
    # the global batch's capacity dropped text choices (of 2 x B x 77),
    # each rank's count the global one
    assert r0["kept"] == r1["kept"]
    assert any(sum(k) < 2 * ttrain.B * 77 for k in r0["kept"][2:])


def test_shards_hold_half(runs):
    """FSDP: every parameter of at least MIN_SIZE elements half on each
    rank; EP: each rank two of the four experts."""
    full = {k: v.size for k, v in runs["spec"]["steps"]["fsdp"]["state"]
            .items()}
    experts = (".moe.wi", ".moe.bi", ".moe.wo", ".moe.bo")
    for case, sharded in (("fsdp", lambda n: full[n] >= MIN_SIZE),
                          ("ep", lambda n: n.endswith(experts))):
        for r in runs["ranks"]:
            counts = r["steps"][case]["counts"]
            for n, c in counts.items():
                want = full[n] // WORLD if sharded(n) else full[n]
                assert c == want, (case, n, c, full[n])
    counts = runs["ranks"][0]["steps"]["fsdp"]["counts"]
    held = sum(counts.values()) / sum(full.values())
    assert 0.5 <= held < 0.6, held


def test_fsdp_ema_matches_one_process(runs):
    one = torch_dist_cases.trajectory(
        {**runs["spec"]["steps"]["fsdp"], "fsdp": False, "ckpt": None},
        None)
    got = runs["ranks"][0]["steps"]["fsdp"]
    for n, e in one["ema"].items():
        np.testing.assert_allclose(got["ema"][n], e, rtol=RTOL, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("rule", list(LEAF_RULES))
def test_fsdp_leaf_rules_match_one_process(runs, rule):
    """Adafactor's factored moments and clip and LARS's trust ratio take
    each whole JAX leaf over FSDP's shards: two steps at world 2 against
    one process on the global batch."""
    spec = runs["spec"]["steps"][f"fsdp_{rule}"]
    one = torch_dist_cases.trajectory({**spec, "fsdp": False}, None)
    got = runs["ranks"][0]["steps"][f"fsdp_{rule}"]
    assert sum(got["counts"].values()) < 0.6 * sum(
        v.size for v in spec["state"].values())
    for i, want in enumerate(one["hist"]):
        for key in ("loss", "grad_norm", "moe_aux_loss"):
            np.testing.assert_allclose(got["hist"][i][key], want[key],
                                       rtol=RTOL, err_msg=f"{rule} {key}")
    for n, v in one["state"].items():
        np.testing.assert_allclose(got["state"][n], v, rtol=RTOL, atol=1e-6,
                                   err_msg=f"{rule} {n}")


def test_world_1_checkpoint_resumes_under_fsdp(runs):
    """One process's step-1 checkpoint, restored into each rank's shards
    (the parameters, Adam's slots, the EMA) at world 2: two more steps
    land where one process's two more steps land."""
    spec = runs["spec"]["steps"]["fsdp_resume"]
    one = torch_dist_cases.trajectory({**spec, "fsdp": False}, None)
    got = runs["ranks"][0]["steps"]["fsdp_resume"]
    for i, want in enumerate(one["hist"]):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got["hist"][i][key], want[key],
                                       rtol=RTOL, err_msg=f"step {i} {key}")
    saved = torch.load(spec["resume"], map_location="cpu",
                       weights_only=True)
    lr_sum = sum(h["lr"] for h in one["hist"])
    # the key rows of in_proj_bias as tests/test_torch_train.py holds them
    for what, start in (("state", saved["model"]), ("ema", saved["ema"])):
        ttrain._assert_params_close(
            got[what], {n: v for n, v in one[what].items() if n in got[what]},
            {n: t.numpy() for n, t in start.items()}, lr_sum, what)


def test_fsdp_checkpoint_resumes_at_world_1(runs):
    """The world-2 FSDP run's step-2 checkpoint holds whole tensors; one
    process restores it and takes step 3 on the whole batch, landing
    where the world-2 run landed."""
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

    spec = runs["spec"]["steps"]["fsdp"]
    model = model_entry(spec["model"])
    model.init_weights(torch.Generator().manual_seed(7))
    named = dict(model.named_parameters())
    sched = scheduler_entry(spec["sched"], max_iter=spec["max_iter"])
    tx = optim_entry(spec["opt"], model, sched, pconfig=spec["pconfig"],
                     grad_clip=tmoe.GRAD_CLIP, frozen_mask=path_prefix_mask(
                         named, model.visual.frozen_param_paths()))
    ema = EmaConfig(*EMA)
    state = new_train_state(model=model, opt_state=tx.init(named),
                            ema_params=init_ema(named, ema))
    path = os.path.join(runs["ckpt"], "ckpt.pth.tar")
    restore_checkpoint(path, state)
    assert state.step == 2
    step = make_train_step(model, tx, spec["loss_cfg"], sched, ema_cfg=ema,
                           total_steps=spec["max_iter"])
    state, metrics = step(state, ttrain._torch_batch(spec["batch"]))
    got = runs["ranks"][0]["steps"]["fsdp"]
    np.testing.assert_allclose(float(metrics["loss"]), got["hist"][2]["loss"],
                               rtol=RTOL)
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), got["state"][n], rtol=RTOL,
                                   atol=1e-5, err_msg=n)


def test_shard_axis_and_expert_placement():
    """Dim 0 where the ranks divide it, else the largest axis that they
    divide, else none; a MoE block's experts go to the owners only where
    the expert group divides them (else they stay replicated, as the
    JAX package's EP rules degrade)."""
    from declip_tpu_torch.parallel.dist import Group
    from declip_tpu_torch.parallel.fsdp import make_plan, shard_axis
    from declip_tpu_torch.parallel.mesh import Mesh, bind_experts

    assert shard_axis((8, 3), 2) == 0
    assert shard_axis((77, 512, 6), 2) == 1
    assert shard_axis((7, 5), 2) is None
    group = Group(None, (0, 1), 0, "gloo")
    mesh = Mesh(group, 2, expert=group)
    for experts, sharded in ((4, True), (3, False)):
        cfg = tmoe._moe_clip_cfg()
        for tower in ("image_encode", "text_encode"):
            cfg["kwargs"][tower]["moe"] = {"num_experts": experts}
        model = bind_experts(model_entry(cfg, device="meta"), mesh)
        plan = make_plan(model, group, mesh=mesh)
        assert bool(plan) == sharded
        assert all(s.kind == "expert" and s.dim == 0
                   for s in plan.shards.values())
        assert len(plan.shards) == (4 * 4 if sharded else 0)


def test_solver_at_world_2_with_each_key(runs):
    plain, fsdp, ep = (runs["ranks"][0]["solver"][k]
                       for k in ("plain", "fsdp", "ep"))
    assert sorted(fsdp["losses"]) == sorted(plain["losses"]) == [1, 2]
    for s in sorted(plain["losses"]):
        np.testing.assert_allclose(fsdp["losses"][s], plain["losses"][s],
                                   rtol=1e-5)
    for k, v in plain["state"].items():
        np.testing.assert_allclose(fsdp["state"][k], v, rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    assert fsdp["held"]["params"] < 0.8 * sum(
        4 * v.size for v in plain["state"].values())
    assert fsdp["eval"] and ep["eval"]
    assert all(np.isfinite(v) for v in ep["losses"].values())
    assert all(v > 0 for v in ep["scalars"]["moe_aux_loss"].values())
    assert ep["held"]["params"] < sum(4 * v.size
                                      for v in ep["state"].values())
    # the EP run's checkpoint is the world-1 format: one process loads it
    cfg_path = runs["spec"]["solver"]["ep"][0]
    ckpts = os.path.join(os.path.dirname(cfg_path), "checkpoints")
    saved = torch.load(os.path.join(ckpts, "ckpt_2.pth.tar"),
                       map_location="cpu", weights_only=True)["model"]
    for k, v in ep["state"].items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)
    assert tuple(saved["visual.transformer.resblocks.0.moe.wi"].shape)[0] \
        == 4
