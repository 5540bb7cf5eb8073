"""What each rank of tests/test_torch_dist.py runs, in a process of its own,
and the launcher that starts the ranks (``spawn``): the port only, torch
and numpy, no JAX, so that a rank starts in seconds. ``run`` takes the
test's spec, joins the gloo group the launcher set up, runs every case on
this rank's rows of each global batch and returns numpy results to the
test, which holds them to the JAX package.
"""

from __future__ import annotations

import copy
import multiprocessing
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
from torch_threads import SINGLE_THREAD

from declip_tpu_torch.parallel import data_group, init_distributed


def _rows(x, group):
    """This rank's contiguous rows of a global batch."""
    if group is None:
        return x
    b = x.shape[0] // group.size
    return x[group.rank * b:(group.rank + 1) * b]


def _np(t):
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------------------------ losses
def loss_value_and_grads(name, inputs, group):
    """One loss of this rank's rows over ``group`` and its gradient with
    respect to this rank's features: {"loss", "grads": {input: rows}}."""
    from declip_tpu_torch.losses import nt_xent_convirt, nt_xent_gather
    from declip_tpu_torch.ops.contrastive import (
        clip_pair_loss,
        gather_features,
        infonce_labels,
        make_pair_loss,
    )
    from declip_tpu_torch.train.method_losses import (
        declip_losses,
        filip_losses,
    )

    x = {k: _rows(torch.from_numpy(v), group).clone().requires_grad_()
         for k, v in inputs.items() if k not in ("scale", "bias")}
    scale = torch.tensor(float(inputs.get("scale", 1.0)))
    if name == "clip":
        loss = clip_pair_loss(x["img"], x["txt"], scale, group)[0]
    elif name in ("ring", "sigmoid_ring"):
        # the ring's blocks move by the differentiable shift
        bias = torch.tensor(float(inputs.get("bias", 0.0)))
        loss = make_pair_loss({"loss_impl": {"type": name}},
                              axis_name=group)(x["img"], x["txt"],
                                               (scale, bias))[0]
    elif name == "nt_xent":
        zi, zj = x["z_i"], x["z_j"]
        labels = infonce_labels(zi.shape[0], group)
        loss = nt_xent_gather(zi, gather_features(zi, group), zj,
                              gather_features(zj, group), labels, 0.1)
    elif name == "convirt":
        loss = nt_xent_convirt(x["z_i"], x["z_j"], axis_name=group)
    elif name == "nn_text":
        out = {"image_embed_1": x["i1"], "image_embed_2": x["i2"],
               "text_embed": x["t"], "text_embed_aug": x["ta"],
               "logit_scale": scale,
               "simsiam": (x["i1"], x["i2"], x["i2"], x["i1"])}
        _, metrics = declip_losses(
            out, {"clip_simsiam_loss_weight": {"nn_text": 1.0}}, group,
            nn_text=(x["nn"],), nn_text_aug=(x["nn_aug"],))
        loss = metrics["clip_nn_text_loss"]
    elif name == "filip":
        out = {"image_embed": x["img"], "text_embed": x["txt"],
               "logit_scale": scale, "logit_scale_dense": scale,
               "dense_image": x["di"], "dense_text": x["dt"],
               "dense_image_sel": x["di_sel"], "dense_text_sel": x["dt_sel"]}
        _, metrics = filip_losses(
            out, {"clip_simsiam_loss_weight": {"clip_dense_loss": 1.0}},
            group)
        loss = metrics["clip_dense_loss"]
    else:
        raise KeyError(name)
    loss.backward()
    return {"loss": float(loss.detach()),
            "grads": {k: _np(v.grad) for k, v in x.items()
                      if v.grad is not None}}


def forgetful_gather_grads(inputs, group):
    """clip_pair_loss's gradient with a planted fault: the gather's backward
    keeps this rank's rows of its own gradient without the sum over the
    ranks."""
    from declip_tpu_torch.ops import contrastive

    cls = contrastive._GatherFeatures
    saved = cls.backward

    def backward(ctx, grad):
        b = grad.shape[0] // ctx.group.size
        return grad[ctx.group.rank * b:(ctx.group.rank + 1) * b], None

    cls.backward = staticmethod(backward)
    try:
        return loss_value_and_grads("clip", inputs, group)
    finally:
        cls.backward = saved


# ------------------------------------------------------------- train steps
def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if np.asarray(v).dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in batch.items()}


def trajectory(spec, group):
    """``make_train_step`` over ``group`` for spec["steps"] steps on this
    rank's rows of spec["batch"], from spec["state"]: -> each step's
    metrics, and the state dict, EMA, bank,
    pointer and guard buffer at the end. With spec["fsdp"] or
    spec["ep"] > 1 the state is sharded (FSDP over parameters of at
    least spec["min_size"] elements; expert groups of ep ranks), the
    state dict and EMA are the whole tensors (``state_to_host``), and
    "counts" has this rank's element count of each parameter; with
    spec["resume"] the state starts from that checkpoint, and with
    spec["ckpt"] a checkpoint is saved there after step
    spec["ckpt_step"]."""
    from declip_tpu_torch.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        state_to_host,
    )
    from declip_tpu_torch.convert import bank_from_jax
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.models.layers import MoeMlpBlock
    from declip_tpu_torch.optim import (
        optim_entry,
        path_prefix_mask,
        scheduler_entry,
    )
    from declip_tpu_torch.parallel.fsdp import (
        MIN_SHARD_SIZE,
        make_plan,
        shard_train_state,
    )
    from declip_tpu_torch.parallel.mesh import bind_experts, make_mesh
    from declip_tpu_torch.train import (
        EmaConfig,
        init_ema,
        make_train_step,
        new_train_state,
    )

    mesh = make_mesh(group, spec.get("ep", 1))
    model = bind_experts(model_entry(spec["model"], data_group=group), mesh)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state"].items()}, strict=True)
    model.train()
    named = dict(model.named_parameters())
    sched = scheduler_entry(spec["sched"], max_iter=spec["max_iter"])
    grad_clip = spec["loss_cfg"]["grad_clip"]
    tx = optim_entry(spec["opt"], model, sched, pconfig=spec["pconfig"],
                     grad_clip=grad_clip, frozen_mask=path_prefix_mask(
                         named, model.visual.frozen_param_paths()))
    ema = EmaConfig(*spec["ema"]) if spec.get("ema") else None
    bank = spec.get("bank")
    state = new_train_state(
        model=model, opt_state=tx.init(named),
        ema_params=init_ema(named, ema) if ema else None,
        with_logit_guard=grad_clip["type"] == "logit_scale_param_ema",
        bank_text=None if bank is None else bank_from_jax(*bank))
    shard_train_state(state, make_plan(
        model, group, fsdp=spec.get("fsdp", False), mesh=mesh,
        min_size=spec.get("min_size", MIN_SHARD_SIZE)), tx)
    if spec.get("resume"):  # each rank cuts its parts of the whole file
        restore_checkpoint(spec["resume"], state)
    counts = {n: p.numel() for n, p in model.named_parameters()}
    step = make_train_step(model, tx, spec["loss_cfg"], sched, ema_cfg=ema,
                           total_steps=spec["max_iter"], axis_name=group)
    batch = _tensors({k: _rows(v, group) for k, v in spec["batch"].items()})
    hist = []
    for i in range(spec["steps"]):
        state, metrics = step(state, batch)
        hist.append({k: float(v) for k, v in metrics.items()})
        if spec.get("ckpt") and i + 1 == spec["ckpt_step"]:
            save_checkpoint(spec["ckpt"], state,
                            write=group is None or group.rank == 0)
    host = state_to_host(state)
    return {"hist": hist, "counts": counts,
            "kept": [m.kept.tolist() for m in model.modules()
                     if isinstance(m, MoeMlpBlock)],
            "state": {k: v.numpy() for k, v in host["model"].items()},
            "ema": None if ema is None else {
                k: v.numpy() for k, v in host["ema"].items()},
            "bank": None if bank is None else _np(state.bank_text.bank),
            "ptr": None if bank is None else state.bank_text.ptr,
            "guard": None if state.logit_ema_buffer is None
            else float(state.logit_ema_buffer)}


def summing_trajectory(spec, group):
    """One step of ``trajectory`` with a planted fault: the gradient
    all-reduce sums over the ranks instead of averaging."""
    from declip_tpu_torch.parallel import comms
    from declip_tpu_torch.train import train_step

    saved = train_step.mean_over_ranks

    def summed(tensors, group):
        out = {}
        for k, v in tensors.items():
            out[k] = comms.all_reduce_(v.clone(), group, op="sum")
        return out

    train_step.mean_over_ranks = summed
    try:
        return trajectory(dict(spec, steps=1), group)
    finally:
        train_step.mean_over_ranks = saved


def poisoned_step(spec, group):
    """One step of ``spec``'s model with a NaN in rank 1's images only:
    {"skipped", "unchanged"} on this rank."""
    spec = copy.deepcopy(spec)
    images = spec["batch"]["images"]
    images[images.shape[0] - 1, 0, 0, 0] = np.nan
    spec["steps"] = 1
    out = trajectory(spec, group)
    same = all(np.array_equal(out["state"][k], v)
               for k, v in spec["state"].items())
    return {"skipped": out["hist"][0]["update_skipped"], "unchanged": same}


def ssl_trajectory(spec, group):
    """MoCo's ``make_train_step`` over ``group`` (None: one process) for
    spec["steps"] steps on this rank's rows of each of spec["batches"],
    from spec["state"] and the queue spec["queue"], the key encoder a copy
    of the model as ``init_moco_state`` makes it: -> each step's metrics,
    the model's and the key encoder's state dicts, the queue and its
    pointer."""
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.models.ssl_builders import init_moco_state
    from declip_tpu_torch.optim import optim_entry, scheduler_entry
    from declip_tpu_torch.train import make_train_step, new_train_state

    model = model_entry(spec["model"], data_group=group)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state"].items()}, strict=True)
    model.train()
    ssl = init_moco_state(model, torch.Generator(), *spec["queue"].shape)
    ssl.queue.copy_(torch.from_numpy(spec["queue"]))
    sched = scheduler_entry(spec["sched"], max_iter=spec["max_iter"])
    tx = optim_entry(spec["opt"], model, sched)
    state = new_train_state(model=model, opt_state=tx.init(
        dict(model.named_parameters())), ssl=ssl)
    step = make_train_step(model, tx, {}, sched, axis_name=group)
    hist = []
    for batch in spec["batches"]:
        state, metrics = step(state, _tensors({
            k: _rows(v, group) for k, v in batch.items()}))
        hist.append({k: float(v) for k, v in metrics.items()})
    return {"hist": hist,
            "state": {k: _np(v) for k, v in model.state_dict().items()},
            "key": {k: _np(v) for k, v in
                    ssl.key_model.state_dict().items()},
            "queue": _np(ssl.queue), "ptr": ssl.queue_ptr}


# ------------------------------------------------------------------ solver
class FedInputs:
    """The solver's inputs made the same at any world size: each image's
    two views a centre crop (no random draws), and the augmented captions
    and MLM masks functions of each caption's own tokens, where the
    loader keys its draws by batch and rank."""

    def __init__(self, solver):
        from declip_tpu_torch.data.dataloader import ClipDataLoader
        from declip_tpu_torch.data.transforms import (
            CenterCrop,
            Compose,
            MultiView,
            Resize,
            to_normalized_array,
        )

        view = Compose([Resize(256), CenterCrop(224), to_normalized_array])
        solver.train_dataset.transform = MultiView([view, view])
        self.cls = ClipDataLoader
        self.saved = ClipDataLoader._build_batch

    def __enter__(self):
        saved = self.saved

        def build(loader, indices, batch_idx):
            batch = saved(loader, indices, batch_idx)
            toks = batch["tokens"]
            batch["tokens_aug"] = np.where(toks > 0, toks[:, ::-1], 0)
            pos = np.arange(toks.shape[1])[None, :]
            pick = ((toks * 7 + pos) % 5 == 0) & (toks > 0) & (pos > 0)
            pick &= toks != toks.max(axis=1, keepdims=True)  # no EOT
            batch["mlm_labels"] = np.where(pick, toks, -100).astype(np.int32)
            batch["mlm_tokens"] = np.where(
                pick, loader.tokenizer.mask_id, toks).astype(toks.dtype)
            return batch

        self.cls._build_batch = build
        return self

    def __exit__(self, *exc):
        self.cls._build_batch = self.saved


def run_solver(cfg_path, sets, device="cpu"):
    """The solver on ``cfg_path`` with ``sets`` and the fed inputs: ->
    {"losses" and "lr" by step, "eval" (the merged zero-shot eval at the
    end) (rank 0's), "start" and "state" (the state dicts before and
    after), "rank"}."""
    import json

    from declip_tpu_torch.config import override, parse_config
    from declip_tpu_torch.solver import Solver

    cfg = parse_config(cfg_path)
    for kv in sets:
        key, _, value = kv.partition("=")
        cfg = override(cfg, key, json.loads(value))
    cfg["_config_path"] = os.path.abspath(cfg_path)
    from declip_tpu_torch.checkpoint import state_to_host

    solver = Solver(cfg, device=device)
    # whole tensors where the state is sharded (every rank gathers)
    start = {k: v.numpy() for k, v in
             state_to_host(solver.state)["model"].items()}
    with FedInputs(solver):
        solver.train()
    losses, lrs, evals, scalars = {}, {}, {}, {}
    events = os.path.join(os.path.dirname(cfg_path), "events",
                          "scalars.jsonl")
    if solver.rank == 0:
        with open(events) as f:
            for line in f:
                row = json.loads(line)
                scalars.setdefault(row["tag"], {})[row["step"]] = \
                    row["value"]
                if row["tag"] in ("loss", "lr"):
                    (losses if row["tag"] == "loss" else lrs)[
                        row["step"]] = row["value"]
                elif row["tag"].startswith("eval0/"):
                    evals[row["tag"][len("eval0/"):]] = row["value"]
    return {"losses": losses, "lr": lrs, "eval": evals, "start": start,
            "rank": solver.rank, "scalars": scalars,
            "held": (solver.state.shards.resident_bytes(solver.state)
                     if solver.state.shards else None),
            "state": {k: v.numpy() for k, v in
                      state_to_host(solver.state)["model"].items()}}


def preempted_solver(cfg_path, sets):
    """The solver with a preemption signal (SIGUSR1) sent to rank 1 alone
    after its first step: -> {"step" at the end, "evals" (calls of
    ``validate``), "ckpts" (rank 0's checkpoint files)}. Every rank must
    leave at that step and none may evaluate: the eval's merge is a
    collective that a rank already gone would never join."""
    import json
    import signal

    from declip_tpu_torch.config import override, parse_config
    from declip_tpu_torch.solver import Solver

    cfg = parse_config(cfg_path)
    for kv in sets:
        key, _, value = kv.partition("=")
        cfg = override(cfg, key, json.loads(value))
    cfg["_config_path"] = os.path.abspath(cfg_path)
    solver = Solver(cfg, device="cpu")
    evals = []
    validate, step = solver.validate, solver._train_step

    def counted(*args):
        evals.append(args)
        return validate(*args)

    def signalled(*args):
        out = step(*args)
        if solver.rank == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    solver.validate, solver._train_step = counted, signalled
    with FedInputs(solver):
        solver.train()
    ckpts = os.path.join(os.path.dirname(cfg_path), "checkpoints")
    return {"step": int(solver.state.step), "evals": len(evals),
            "ckpts": sorted(os.listdir(ckpts)) if solver.rank == 0
            else None}


# -------------------------------------------------------------------- rank
def run(rank, spec):
    """Every case of ``spec`` on this rank -> {case: result}."""
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60)
    group = data_group()
    out = {"losses": {name: loss_value_and_grads(name, inputs, group)
                      for name, inputs in spec["losses"].items()},
           "forgetful_gather": forgetful_gather_grads(
               spec["losses"]["clip"], group),
           "steps": {name: trajectory(s, group)
                     for name, s in spec["steps"].items()},
           "summing": summing_trajectory(spec["steps"]["clip"], group),
           "poisoned": poisoned_step(spec["steps"]["clip"], group),
           "ssl": ssl_trajectory(spec["ssl"], group)}
    out["solver"] = run_solver(*spec["solver"])
    out["preempted"] = preempted_solver(*spec["preempted"])
    return out


def run_sharded(rank, spec):
    """tests/test_torch_fsdp_ep.py's cases on this rank -> {case:
    result}: each step case through ``trajectory``, then the solver
    runs."""
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60)
    group = data_group()
    out = {"steps": {name: trajectory(s, group)
                     for name, s in spec["steps"].items()}}
    out["solver"] = {name: run_solver(*args)
                     for name, args in spec["solver"].items()}
    return out


# ------------------------------------------------------------------ launch
def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, results):
    # the rank's own environment: what it starts inherits the thread caps
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port), **SINGLE_THREAD})
    torch.set_num_threads(1)
    try:
        # by value: a tensor sent as shared memory would not outlive its
        # rank
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:  # the parent raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        from declip_tpu_torch.parallel.dist import shutdown

        shutdown()


def spawn(fn, world, args=(), *, timeout_s):
    """``fn(rank, *args)`` on ``world`` spawned ranks, each with torchrun's
    variables and the thread caps of ``torch_threads`` set in its own
    entry -> their return values in rank order. A rank that
    raises, dies or outlives ``timeout_s`` fails the launch, and every
    rank still running is killed."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, fn, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world - len(out)} of {world} ranks did not finish "
                    f"within {timeout_s:.0f} s")
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            try:
                # a rank that has exited flushed its result first
                rank, ok, value = results.get(
                    timeout=5.0 if dead else min(left, 1.0))
            except queue_mod.Empty:
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before returning")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
    return [out[r] for r in range(world)]
