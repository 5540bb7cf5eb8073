"""GradCache: the full batch's contrastive gradient at 1/M of the towers'
activation memory (port of declip_tpu/train/grad_cache.py; Gao et al.
2021, "Scaling Deep Contrastive Learning Batch Size under Memory Limited
Setup", arXiv:2101.06983).

The contrastive methods couple samples only through the loss, so the
gradient splits into each chunk's tower Jacobian times the loss's
cotangent on that chunk's outputs. The step runs in three passes, none of
which holds more than one chunk's tower activations:

1. the embedding pass: each of the M chunks forward under
   ``torch.no_grad()``;
2. the loss pass: the loss over the merged outputs, taken as leaves that
   require grad, differentiated with respect to them and to the
   parameters the loss itself reads;
3. the gradient pass: each chunk forward again, then its backward with the
   cached cotangent of its outputs.

An output that does not depend on the sample (``logit_scale``,
``logit_bias``, ``logit_scale_dense``) is the same in every chunk: its
cotangent is split evenly over the M re-forwards, whose sum gives its
parameter's gradient, as in the JAX package. The cost is one more
forward. The re-forward must give the outputs that the embedding pass
gave: same chunk shapes, same compute dtype; the attention kernels are
deterministic.

Config: ``grad_cache: {chunks: M}`` (M divides the per-rank batch). The
train step refuses what JAX refuses (train_step.py:238-281 there):
BatchNorm in the train forward (every ResNet tower, and DeCLIP, SLIP and
DeFILIP through their SimSiam heads), MoE towers and the SSL methods.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def _split(batch: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The batch as ``n`` chunks of rows."""
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for key, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"grad_cache: batch {b} not divisible by "
                             f"chunks={n}")
        for i, part in enumerate(x.chunk(n)):
            out[i][key] = part
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rebuild(tree, leaves: List[torch.Tensor]):
    """``tree`` with its tensors replaced, in ``_leaves`` order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(tree)


def cached_value_and_grad(
        model: torch.nn.Module, losses_from_out: Callable, state,
        batch: Dict[str, Any], n_chunks: int,
        params: Dict[str, torch.Tensor],
        reforward_diff: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, Dict, Dict[str, Any], Dict[str, torch.Tensor]]:
    """The three passes over ``batch`` in ``n_chunks`` chunks -> (loss,
    metrics, the merged outputs, ``{name: gradient or None}``), what the
    unchunked step's forward and ``torch.autograd.grad`` give.
    ``losses_from_out(model, state, out) -> (loss, metrics)`` is the
    step's loss assembly. ``reforward_diff``: where given, the largest
    absolute difference between the embedding pass's outputs and the
    gradient pass's is written there under ``"max_abs"``."""
    chunks = _split(batch, n_chunks)
    chunk_b = next(iter(chunks[0].values())).shape[0]

    # 1. embeddings, no graph
    with torch.no_grad():
        outs = [model(ch) for ch in chunks]
    per_sample = [x.ndim >= 1 and x.shape[0] == chunk_b
                  for x in _leaves(outs[0])]
    stacked = [_leaves(o) for o in outs]
    merged = []
    for j, ps in enumerate(per_sample):
        x = (torch.cat([s[j] for s in stacked]) if ps else stacked[0][j])
        if x.is_floating_point():
            x = x.detach().requires_grad_()
        merged.append(x)
    out = _rebuild(outs[0], merged)
    del outs

    # 2. the loss over the merged outputs
    names = list(params)
    diff = [x for x in merged if x.requires_grad]
    total, metrics = losses_from_out(model, state, out)
    grads = torch.autograd.grad(total, diff + [params[n] for n in names],
                                allow_unused=True)
    cot = dict(zip(map(id, diff), grads[:len(diff)]))
    acc: Dict[str, Optional[torch.Tensor]] = dict(
        zip(names, grads[len(diff):]))

    # 3. each chunk forward again, backward with its cotangents
    worst = 0.0
    for i, ch in enumerate(chunks):
        leaves = _leaves(model(ch))
        outs_i, cots_i = [], []
        for j, (x, ps) in enumerate(zip(leaves, per_sample)):
            c = cot.get(id(merged[j]))
            if reforward_diff is not None and x.is_floating_point():
                ref = (merged[j][i * chunk_b:(i + 1) * chunk_b] if ps
                       else merged[j])
                worst = max(worst, float((x.detach().float()
                                          - ref.detach().float()).abs()
                                         .max()))
            if c is None or not x.requires_grad:
                continue
            outs_i.append(x)
            cots_i.append(c[i * chunk_b:(i + 1) * chunk_b] if ps
                          else c / n_chunks)
        if not outs_i:
            continue
        parts = torch.autograd.grad(outs_i, [params[n] for n in names],
                                    cots_i, allow_unused=True)
        for n, g in zip(names, parts):
            if g is not None:
                acc[n] = g if acc[n] is None else acc[n] + g
    if reforward_diff is not None:
        reforward_diff["max_abs"] = worst
    return total, metrics, out, acc
