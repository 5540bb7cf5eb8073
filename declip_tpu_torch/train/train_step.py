"""The training step (port of declip_tpu/train/train_step.py; methods clip,
slip, filip, declip and defilip, and the SSL builders' moco, simclr and
clsa).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``, the reference's train-loop body (prototype/solver/
clip_solver.py:380-560): forward, loss, backward, the optimizer's update
(grad clip, the configured rule, pconfig decay, frozen mask), the
post-step logit-scale guard and the EMA. Under ``grad_cache: {chunks: M}``
the forward and backward run in M chunks (train/grad_cache.py). The step
updates ``state`` in place and returns it.

``loss_fn(model, state, batch) -> (loss, metrics)`` is kept apart from the
update, as in the JAX package: the gradient of its loss with respect to the
model's parameters is what ``jax.value_and_grad`` gives there.

DeCLIP and DeFILIP (train_step.py:149-199, 304-308 of the JAX package): the
step queries
the NN text bank with both captions' features before the loss, normalizes
the neighbours, and projects them for nn-SimSiam (``project_nn_text``);
after an accepted step it enqueues the augmented captions' features, then
the originals'.

MoCo and CLSA (train_step.py:209-222, 265-272, 310-320 of the JAX package),
in its order: the momentum update of the key encoder from the parameters
before this step's update; the keys of view 2 through it, with no
gradient (its attention launches K1 and never K2); the loss against the
queue as it stood before the step; the update; and after an accepted step
the enqueue of the keys, the global batch's in rank order over a data
group, as DeCLIP's bank. SimCLR takes no state.

Non-finite containment (train_step.py:323-352; the reference checks every
iteration, declip_solver.py:548-619): a NaN/inf loss or gradient leaves the
parameters, optimizer state, EMA, guard buffers, BatchNorm running
statistics, the NN bank and the SSL state (the momentum-updated key
parameters, the queue and its pointer, the key encoder's BatchNorm
statistics) untouched (bit-identical) and reports
``update_skipped == 1``; the step counter still advances. The port decides
it on the host: the loss and the global gradient norm come to the host once
per step (one device synchronisation), and a poisoned step never runs the
update. BatchNorm leaves its new statistics pending through the forward
(models/layers.py), and the step commits them only after a finite one. The
same read gives the norm clip its norm. The step puts the model in training
mode, as the JAX step applies it with ``train=True``.

MoE towers (models/layers.py ``MoeMlpBlock``; train_step.py:142-149,
196-235 of the JAX package): the towers' training forwards leave their
aux loss on the model, and the step adds it to the loss and reports it
as ``moe_aux_loss``.

FSDP and expert parallelism (``state.shards``, parallel/fsdp.py): the
forward and backward run with the sharded parameters gathered whole,
each shard's gradient is the mean of the global batch's from the
gather's reduce-scatter, and the global norm counts each shard once
(``mean_grads``); MoCo's momentum update reads the whole parameters,
and its key encoder stays whole.

Data parallelism (``axis_name``, the data group): each rank runs the step
on its own rows of the global batch, with every global-batch loss term
over gathered features (method_losses.py). After the backward the
gradients are averaged over the group, flattened into a few buckets and
all-reduced each (JAX's ``pmean``, train_step.py:289-291 there), and so
are the metrics; the finite decision reads the averaged loss and the norm
of the averaged gradients, so that every rank skips a step or none does.
DeCLIP's bank enqueues the global batch's features, gathered in rank
order, as the JAX solver's GSPMD step enqueues its global arrays
(train_step.py:304-308 there; its shard_map mode enqueues each device's
own rows instead, a mode the solver does not run): every rank's bank stays
the same, and the neighbour query stays local. The step all-reduces
explicitly rather than through ``DistributedDataParallel``: it calls the
towers several times a backward, which DDP's reducer does not expect, and
DDP's ``broadcast_buffers`` would overwrite BatchNorm's pending
statistics. Device-side draws (``device_aug``) are keyed by (seed, step,
rank).

``device_aug`` (train_step.py:255-263 of the JAX package): the batch's
images arrive as the loader's uint8 geometry crops, [B, H, W, 3*views], and
the step runs MOCOV2's photometric half on the device before the forward
(data/device_aug.py), its draws keyed by (seed, step, view). ``check_grad``
adds each top-level module's gradient norm to the metrics under the JAX
package's tags, ``grad_norm/<module>`` (train_step.py:357-361 there).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from declip_tpu_torch.data.device_aug import augment_views, fold_in
from declip_tpu_torch.models.clip_model import CLIP, l2_normalize
from declip_tpu_torch.models.declip_model import DECLIP
from declip_tpu_torch.models.defilip_model import DEFILIP
from declip_tpu_torch.models.filip_model import FILIP
from declip_tpu_torch.models.layers import (
    BatchNorm,
    commit_bn_stats,
    discard_bn_stats,
    pop_moe_aux,
)
from declip_tpu_torch.models.memory_bank import enqueue, query_topk
from declip_tpu_torch.models.slip_model import SLIP
from declip_tpu_torch.models.ssl_builders import (
    SSLModel,
    encode_keys,
    enqueue_keys,
    momentum_update,
    restore_keys,
)
from declip_tpu_torch.ops.contrastive import gather_features, make_pair_loss
from declip_tpu_torch.optim import global_norm
from declip_tpu_torch.parallel import comms
from declip_tpu_torch.train import method_losses
from declip_tpu_torch.train.ema import EmaConfig, ema_step
from declip_tpu_torch.train.grad_cache import cached_value_and_grad
from declip_tpu_torch.train.state import TrainState

_PASS_THROUGH = (None, "norm", "value", "logit_scale_grad", "constant")

# the port's top-level parameter names that the JAX package's tree names
# otherwise (convert.py's one top-level rename)
_JAX_TOP = {"encode_text": "text"}


_LOSSES = {"clip": method_losses.clip_losses,
           "slip": method_losses.slip_losses,
           "filip": method_losses.filip_losses,
           "declip": method_losses.declip_losses,
           "defilip": method_losses.defilip_losses}
# the methods whose loss takes the NN bank's inputs and the step count
_BANK_METHODS = ("declip", "defilip")
_SSL_METHODS = ("moco", "simclr", "clsa")
# the SSL methods with a momentum encoder and a queue (TrainState.ssl)
_MOCO_METHODS = ("moco", "clsa")


def method_of(model) -> str:
    if isinstance(model, SSLModel):
        return model.ssl_method
    # DEFILIP subclasses DECLIP: the most specific class first
    for cls, method in ((DEFILIP, "defilip"), (DECLIP, "declip"),
                        (FILIP, "filip"), (SLIP, "slip"), (CLIP, "clip")):
        if isinstance(model, cls):
            return method
    raise NotImplementedError(
        f"{type(model).__name__}: no training method (CLIP, SLIP, FILIP, "
        f"DeCLIP, DeFILIP, or an SSLModel's MoCo, SimCLR or CLSA)")


@torch.no_grad()
def logit_scale_guard(s_old: torch.Tensor, logit_scale: torch.Tensor,
                      grad_clip: Dict, state: TrainState
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Post-step logit-scale clamps (clip_solver.py:500-523,
    declip_solver.py:64-86,694-706), in place on the ``logit_scale``
    parameter; ``s_old`` is its value before the update. Returns the new
    (ema_buffer, clip_count)."""
    kind = (grad_clip or {}).get("type")
    buffer, count = state.logit_ema_buffer, state.logit_clip_count
    if kind in _PASS_THROUGH:
        return buffer, count
    s_new = logit_scale.detach().clone()
    if kind == "logit_scale_param":
        v = float(grad_clip["value"])
        s = torch.clamp(s_new, s_old - v, s_old + v)
    elif kind == "logit_scale_param_abs_min":
        # the reference clamps BOTH before backward and after the step
        # (clip_solver.py:506,520): the update applies to the clamped value
        v = float(grad_clip["value"])
        s = torch.clamp(torch.clamp(s_old, min=v) + (s_new - s_old), min=v)
    elif kind == "logit_scale_param_value":
        v = float(grad_clip["value"])
        mv = float(grad_clip["max_value"])
        s = torch.clamp(torch.clamp(s_old, v, mv) + (s_new - s_old), v, mv)
    elif kind == "logit_scale_param_ema":
        # the reference passes config.grad_clip.value as the threshold
        # (declip_solver.py:387-388); 'threshold' kept as an alias
        thr = float(grad_clip.get("threshold", grad_clip.get("value", 0.2)))
        momentum = 0.9
        clipped = torch.clamp(s_new, buffer - thr, buffer + thr)
        count = count + (clipped != s_new).any().to(count.dtype)
        s = clipped
        buffer = momentum * buffer + (1 - momentum) * s.mean()
    else:
        raise NotImplementedError(f"grad_clip type {kind!r}")
    logit_scale.copy_(s)
    return buffer, count


def _bank_kwargs(model, state: TrainState, out) -> Dict:
    """DeCLIP's and DeFILIP's bank inputs to the loss: the neighbours of both captions'
    features in the bank as it stood before this step, normalized, and
    with return_simsiam_nn_text the projector over them."""
    if not getattr(model, "return_nn_bank", False):
        return {}
    if state is None or state.bank_text is None:
        raise ValueError("return_nn_bank needs a train state with a "
                         "bank_text (models.memory_bank.init_bank)")
    topk = int(model.nn_topk)
    nn_text = tuple(l2_normalize(t, eps=1e-10) for t in
                    query_topk(state.bank_text, out["text_embed"], topk))
    nn_aug = tuple(l2_normalize(t, eps=1e-10) for t in
                   query_topk(state.bank_text, out["text_embed_aug"], topk))
    kwargs = {"nn_text": nn_text, "nn_text_aug": nn_aug}
    if model.return_simsiam_nn_text:
        kwargs["nn_simsiam"] = (out["nn_simsiam_p_text"],
                                [model.project_nn_text(t) for t in nn_text])
    return kwargs


def make_losses_from_out(cfg: Dict, method: str = "clip",
                         axis_name: Optional[str] = None,
                         total_steps: int = 1) -> Callable:
    """``losses(model, state, out) -> (loss, metrics)``: the loss of
    ``method`` over the model's feature dict ``out`` (with DeCLIP's and
    DeFILIP's bank query, which reads ``state``; MoCo's and CLSA's against
    ``state.ssl``'s queue, with the keys under ``out["k"]``)."""
    if method not in _LOSSES and method not in _SSL_METHODS:
        raise NotImplementedError(
            f"method {method!r}: not one of {', '.join(_LOSSES)}, "
            f"{', '.join(_SSL_METHODS)}")
    losses = _LOSSES.get(method)
    pair_loss = make_pair_loss(cfg, axis_name=axis_name)

    def from_out(model, state: Optional[TrainState], out):
        if method == "simclr":
            return method_losses.simclr_losses(
                out, axis_name, temperature=float(model.T))
        if method in _MOCO_METHODS:
            return method_losses.moco_losses(
                out, k=out["k"], queue=state.ssl.queue,
                temperature=float(model.T),
                clsa_ratio=float(model.clsa_ratio),
                clsa_avg=bool(model.clsa_avg))
        if method not in _BANK_METHODS:
            return losses(out, cfg, axis_name, pair_loss)
        return losses(out, cfg, axis_name, pair_loss=pair_loss,
                      step=state.step if state is not None else 0,
                      total_steps=total_steps,
                      **_bank_kwargs(model, state, out))

    return from_out


def make_loss_fn(cfg: Dict, method: str = "clip",
                 axis_name: Optional[str] = None,
                 total_steps: int = 1) -> Callable:
    """``loss_fn(model, state, batch) -> (loss, metrics)`` for ``method``
    (MoCo's and CLSA's keys from ``state.ssl``'s key encoder as it
    stands; a MoE tower's aux loss added, as the step adds it)."""
    from_out = make_losses_from_out(cfg, method, axis_name, total_steps)

    def loss_fn(model, state: Optional[TrainState], batch):
        pop_moe_aux(model)
        out = forward(model, state, batch, method)
        return with_moe_aux(model, *from_out(model, state, out))

    return loss_fn


def with_moe_aux(model, total, metrics):
    """The loss with the aux loss of the MoE towers' training forwards
    added and reported as ``moe_aux_loss`` (train_step.py:196-198 of the
    JAX package; ``loss`` stays the method's, as there)."""
    aux = pop_moe_aux(model)
    if aux is None:
        return total, metrics
    metrics = dict(metrics, moe_aux_loss=aux)
    return total + aux, metrics


def forward(model, state: Optional[TrainState], batch, method: str):
    """The model's feature dict, with MoCo's and CLSA's keys of view 2
    under ``k`` (``ssl_builders.encode_keys``)."""
    out = model(batch)
    if method in _MOCO_METHODS:
        out["k"] = encode_keys(state.ssl, batch)
    return out


def grad_norms_by_module(grads: Dict[str, torch.Tensor], plan=None
                         ) -> Dict[str, torch.Tensor]:
    """``check_grad``'s metrics: ``grad_norm/<module>`` for each top-level
    entry of the parameter tree, under the JAX package's names (device
    scalars; over the shards of ``plan``)."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, g in grads.items():
        top = name.split(".", 1)[0]
        groups.setdefault(_JAX_TOP.get(top, top), {})[name] = g
    return {f"grad_norm/{top}": (plan.global_norm(gs) if plan
                                 else global_norm(list(gs.values())))
            for top, gs in groups.items()}


# the gradient all-reduce's bucket: about 100 MB of fp32
_BUCKET_ELEMS = 1 << 25


def mean_over_ranks(tensors: Dict[str, torch.Tensor], group
                    ) -> Dict[str, torch.Tensor]:
    """The mean over ``group`` of each tensor, flattened into buckets of
    about ``_BUCKET_ELEMS`` elements of one dtype, one all-reduce each."""
    out: Dict[str, torch.Tensor] = {}

    def reduce(bucket):
        flat = torch.cat([tensors[n].reshape(-1) for n in bucket])
        comms.all_reduce_(flat, group, op="mean")
        sizes = [tensors[n].numel() for n in bucket]
        for n, part in zip(bucket, flat.split(sizes)):
            out[n] = part.view_as(tensors[n])

    bucket, size = [], 0
    for n, t in tensors.items():
        if bucket and (size + t.numel() > _BUCKET_ELEMS
                       or t.dtype != tensors[bucket[0]].dtype):
            reduce(bucket)
            bucket, size = [], 0
        bucket.append(n)
        size += t.numel()
    if bucket:
        reduce(bucket)
    return out


def mean_grads(grads: Dict[str, torch.Tensor], group, plan=None
               ) -> Dict[str, torch.Tensor]:
    """The gradient of the global batch's loss from each rank's: the mean
    over ``group`` of the replicated parameters' (``mean_over_ranks``);
    an FSDP shard's gradient, which the gather's backward summed over the
    ranks already, over the world size; an expert shard's summed over
    the ranks that hold the same experts (its owner's gradient took its
    expert group's tokens), over the world size (parallel/fsdp.py)."""
    if not plan:
        return mean_over_ranks(grads, group)
    out = mean_over_ranks({n: g for n, g in grads.items()
                           if n not in plan.shards}, group)
    for n, shard in plan.shards.items():
        g = grads[n]
        if shard.kind == "expert" and shard.replicas is not None:
            g = comms.all_reduce_(g.contiguous(), shard.replicas)
        out[n] = g / group.size
    return {n: out[n] for n in grads}


def gathered(plan, differentiable: bool = True):
    """``plan.gathered`` for the step's forward and backward, a null
    context without a plan."""
    if not plan:
        return contextlib.nullcontext()
    return plan.gathered(differentiable=differentiable)


def rank_seed(seed: int, axis_name) -> int:
    """The seed of this rank's device-side draws: ``seed`` on rank 0 (and
    with one process), folded with the rank elsewhere."""
    if axis_name is None or axis_name.rank == 0:
        return seed
    return fold_in(seed, axis_name.rank)


def make_augment(model, device_aug: Dict, seed: int = 0) -> Callable:
    """``augment(images_u8, step)``: the on-device photometrics of
    ``device_aug`` (``{"views", "preset"}``), in the image tower's dtype.
    Raises on images that are not uint8: only the loader's geometry crops
    (``build_geometry_augmentation``) may reach it."""
    views = int(device_aug.get("views", 2))
    preset = str(device_aug.get("preset", "MOCOV2"))
    dtype = getattr(model, "dtype", None) or model.visual.dtype

    def augment(images: torch.Tensor, step: int) -> torch.Tensor:
        if images.dtype != torch.uint8:
            raise TypeError(
                f"device_aug takes the loader's uint8 geometry crops, got "
                f"{images.dtype} images {tuple(images.shape)}: the loader "
                f"did not run build_geometry_augmentation (with worker_type "
                f"process, pass it to build_clip_dataloader as transform=)")
        return augment_views(images, views=views, preset=preset, seed=seed,
                             step=step, dtype=dtype)

    return augment


def check_grad_cache(model, method: str) -> None:
    """JAX's refusals of ``grad_cache`` (train_step.py:238-281 there),
    with its reasons: GradCache needs a forward in which no sample sees
    another."""
    if method in _SSL_METHODS:
        raise NotImplementedError(
            "grad_cache does not support SSL methods (queue/momentum "
            "state couples steps)")
    for tower in ("visual", "encode_text"):
        if getattr(getattr(model, tower, None), "moe_experts", 0):
            raise NotImplementedError(
                "grad_cache + MoE towers: router capacity and aux loss "
                "are batch-coupled in the forward")
    if any(isinstance(m, (torch.nn.modules.batchnorm._BatchNorm, BatchNorm))
           for m in model.modules()):
        raise NotImplementedError(
            "grad_cache requires BatchNorm-free towers (ViT); this model "
            "carries batch_stats")


def make_train_step(model, tx, cfg: Dict, schedule: Callable, *,
                    method: Optional[str] = None,
                    ema_cfg: Optional[EmaConfig] = None,
                    total_steps: int = 1,
                    device_aug: Optional[Dict] = None,
                    seed: int = 0, axis_name=None) -> Callable:
    """The step for ``model``'s method, with the update rule ``tx`` from
    ``optim_entry`` and the lr ``schedule`` (for the ``lr`` metric).
    ``cfg``'s ``grad_cache: {chunks: M}`` runs the forward and backward in
    M chunks (train/grad_cache.py).
    ``total_steps``: the run's length, for DeCLIP's ``linear`` loss
    weights. ``device_aug`` (``{"views", "preset"}``): the images are uint8
    crops, augmented on the device with draws keyed by ``seed``, the step
    and the rank (``make_augment``). ``axis_name``: the data group
    (``parallel.Group``), or None for one process; the model's BatchNorms
    take theirs from ``model_entry(..., data_group=)``."""
    method = method or method_of(model)
    grad_clip = dict(cfg.get("grad_clip") or {})
    if grad_clip.get("type") not in _PASS_THROUGH and \
            getattr(model, "logit_scale", None) is None:
        raise ValueError(f"grad_clip {grad_clip['type']!r} guards a "
                         f"logit_scale, which {type(model).__name__} has "
                         f"not")
    gc_chunks = int((cfg.get("grad_cache") or {}).get("chunks", 0) or 0)
    if gc_chunks > 1:
        check_grad_cache(model, method)
    from_out = make_losses_from_out(cfg, method, axis_name=axis_name,
                                    total_steps=total_steps)
    use_bank = bool(getattr(model, "return_nn_bank", False))
    check_grad = bool(cfg.get("check_grad", False))
    moco = method in _MOCO_METHODS
    augment = (make_augment(model, device_aug, rank_seed(seed, axis_name))
               if device_aug is not None else None)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if augment is not None:
            batch = dict(batch, images=augment(batch["images"], state.step))
        model = state.model
        if not model.training:
            model.train()
        params = state.params
        plan = state.shards
        discard_bn_stats(model)  # statistics of a forward outside a step
        pop_moe_aux(model)  # and aux losses
        if moco:
            if state.ssl is None:
                raise ValueError(
                    f"{method} needs a train state with its key encoder "
                    f"and queue: new_train_state(ssl=ssl_builders."
                    f"init_moco_state(...))")
            discard_bn_stats(state.ssl.key_model)
            # from the parameters before this step's update
            # (moco_builder.py:50-53); the key encoder stays whole
            with gathered(plan, differentiable=False):
                old_keys = momentum_update(state.ssl, model, float(model.m))
        with gathered(plan):
            if gc_chunks > 1:
                total, metrics, out, grads = cached_value_and_grad(
                    model, from_out, state, batch, gc_chunks, params)
                grads = [grads[n] for n in params]
            else:
                out = forward(model, state, batch, method)
                total, metrics = with_moe_aux(
                    model, *from_out(model, state, out))
                grads = torch.autograd.grad(total, list(params.values()),
                                            allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient: it
        # still decays, as under optax
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if axis_name is not None:
            grads = mean_grads(grads, axis_name, plan)
            keys = list(metrics)
            reduced = torch.stack([metrics[k].float() for k in keys])
            comms.all_reduce_(reduced, axis_name, op="mean")
            metrics = dict(zip(keys, reduced.unbind()))
        grad_norm = (plan.global_norm(grads) if plan
                     else global_norm(list(grads.values())))
        # the one host read of the step
        loss_v, norm_v = torch.stack(
            [metrics["loss"].float(), grad_norm]).tolist()
        finite = math.isfinite(loss_v) and math.isfinite(norm_v)
        if finite:
            logit_scale = params.get("logit_scale")
            s_old = (None if logit_scale is None
                     else logit_scale.detach().clone())
            tx.update_(grads, state.opt_state, params, grad_norm=norm_v)
            if logit_scale is not None:
                state.logit_ema_buffer, state.logit_clip_count = \
                    logit_scale_guard(s_old, logit_scale, grad_clip, state)
            if state.ema_params is not None and ema_cfg is not None:
                ema_step(state.ema_params, params, state.step + 1, ema_cfg)
            commit_bn_stats(model)
            if use_bank:
                # aug first, then orig (declip.py:288-291); the global
                # batch's rows in rank order
                with torch.no_grad():
                    for key in ("text_embed_aug", "text_embed"):
                        enqueue(state.bank_text, gather_features(
                            out[key].detach(), axis_name))
            if moco:
                commit_bn_stats(state.ssl.key_model)
                # the global batch's keys in rank order
                # (concat_all_gather, moco_builder.py:57-68)
                enqueue_keys(state.ssl, gather_features(out["k"], axis_name))
        else:
            discard_bn_stats(model)
            if moco:
                discard_bn_stats(state.ssl.key_model)
                restore_keys(state.ssl, old_keys)
        metrics["lr"] = schedule(state.step)
        metrics["grad_norm"] = grad_norm
        metrics["update_skipped"] = 0.0 if finite else 1.0
        if check_grad:
            metrics.update(grad_norms_by_module(grads, plan))
        if state.logit_clip_count is not None:
            metrics["logit_clip_count"] = state.logit_clip_count
        state.step += 1
        return state, metrics

    return train_step
