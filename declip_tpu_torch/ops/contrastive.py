"""Global-batch contrastive losses (port of declip_tpu/ops/contrastive.py:
every ``loss_impl`` mode).

The reference's gathered-feature InfoNCE (prototype/model/clip.py:25-49,
136-144, prototype/loss_functions/loss.py:24-47). ``axis_name`` is the data
group (``parallel.Group``) or None for one process. Over a group each rank
holds its own [B, D] rows: ``gather_features`` is a differentiable
all-gather in rank order, whose backward sums the gathered gradient over
the ranks and keeps this rank's rows (the reference's AllGather.backward,
clip.py:42-49; JAX's psum_scatter), and the labels are ``rank * B +
arange(B)``. Each rank's loss is then the mean over its own rows, and the
train step's mean of the gradients over the ranks is the gradient of the
global batch's loss.

The modes (``make_pair_loss``):

- ``full``: the gathered [B, GB] logits;
- ``chunked``: the row-wise log-sum-exp over column chunks, each chunk's
  logits recomputed in the backward (``torch.utils.checkpoint``, JAX's
  ``jax.checkpoint`` on its scan body), so that neither pass holds
  [B, GB];
- ``ring``: no gather; the local block circulates over the group by a
  differentiable shift (``lax.ppermute`` there, ``comms.shift`` here, its
  backward the reverse shift) and each of the W tiles [B, B] folds into a
  running log-sum-exp. With one process it is a ring of one tile;
- ``sigmoid``, ``sigmoid_chunked``, ``sigmoid_ring``: SigLIP's pairwise
  sigmoid loss with the model's ``logit_bias``, which decomposes exactly
  over column blocks.

The tile products stay ``torch.matmul``: the JAX package computes them in
XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from declip_tpu_torch.parallel import comms


class _GatherFeatures(torch.autograd.Function):
    """All-gather in rank order; the backward reduce-scatters: every rank's
    loss reaches every rank's rows."""

    @staticmethod
    def forward(ctx, feat, group):
        ctx.group = group
        return comms.all_gather(feat, group)

    @staticmethod
    def backward(ctx, grad):
        return comms.reduce_scatter(grad, ctx.group), None


class _Shift(torch.autograd.Function):
    """The ring's hop: this rank's block to rank+1, rank-1's block here;
    the backward sends the gradient the other way (``lax.ppermute``'s
    transpose)."""

    @staticmethod
    def forward(ctx, blk, group):
        ctx.group = group
        return comms.shift(blk, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return comms.shift(grad, ctx.group, -1), None


def gather_features(feat: torch.Tensor, axis_name=None) -> torch.Tensor:
    """The [W*B, ...] features of every rank of the group ``axis_name``, in
    rank order, differentiable; the identity with one process
    (``axis_name`` None)."""
    if axis_name is None:
        return feat
    return _GatherFeatures.apply(feat, axis_name)


def similarity_logits(feat_a: torch.Tensor, feat_b_gathered: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """[B_local, D] x [B_global, D] -> [B_local, B_global] in fp32.

    The JAX package multiplies the compute-dtype features with fp32
    accumulation; widening them first is the same product (bf16 products
    are exact in fp32)."""
    sim = torch.matmul(feat_a.float(), feat_b_gathered.float().t())
    return scale.float() * sim


def infonce_labels(batch_size: int, axis_name=None,
                   device=None) -> torch.Tensor:
    """Positive indices ``rank * B + arange(B)`` (loss.py:37-42): this
    rank's rows among the gathered columns; ``arange(B)`` with one
    process."""
    base = torch.arange(batch_size, device=device)
    if axis_name is None:
        return base
    return axis_name.rank * batch_size + base


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows; logits fp32 [N, C], labels int [N]."""
    return F.cross_entropy(logits, labels)


def clip_infonce(logits_per_image: torch.Tensor,
                 logits_per_text: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE (ClipInfoCELoss, loss.py:37-47)."""
    li = cross_entropy(logits_per_image, labels)
    lt = cross_entropy(logits_per_text, labels)
    return (li + lt) / 2


def clip_pair_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                   scale: torch.Tensor, axis_name=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full gathered CLIP loss for one (image, text) feature pair ->
    (loss, logits_per_image, labels); logits and labels feed the accuracy
    meters (clip_solver.py:421-430)."""
    g_img = gather_features(image_embed, axis_name)
    g_txt = gather_features(text_embed, axis_name)
    logits_i = similarity_logits(image_embed, g_txt, scale)
    logits_t = similarity_logits(text_embed, g_img, scale)
    labels = infonce_labels(image_embed.shape[0], axis_name,
                            device=image_embed.device)
    return clip_infonce(logits_i, logits_t, labels), logits_i, labels


def chunked_cross_entropy(feat_a: torch.Tensor, feat_b_gathered: torch.Tensor,
                          scale: torch.Tensor, labels: torch.Tensor,
                          chunk_size: int = 1024) -> torch.Tensor:
    """Row-wise CE over ``scale * feat_a @ feat_b_gathered.T`` without the
    [B, GB] logits (contrastive.py:114-169 of the JAX package): the
    log-sum-exp runs over column chunks of ``chunk_size`` with a running
    max and sum, and each chunk's body is checkpointed, so the forward
    holds one [B, chunk] block and the backward recomputes each block in
    turn. The positive logit is one [B] gather and dot."""
    a = feat_a.float()
    b = feat_b_gathered.float()
    s32 = scale.float()
    gb = b.shape[0]
    c = min(int(chunk_size), gb)

    def body(m, s, blk):
        logits = s32 * torch.matmul(a, blk.t())
        # a chunk of -inf logits: keep the running max finite
        bmax = torch.clamp(logits.amax(dim=-1), min=-1e30)
        new_m = torch.maximum(m, bmax)
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=-1)
        return new_m, s

    m = a.new_full((a.shape[0],), -float("inf"))
    s = a.new_zeros((a.shape[0],))
    for beg in range(0, gb, c):
        m, s = checkpoint(body, m, s, b[beg:beg + c], use_reentrant=False)
    lse = m + torch.log(s)
    pos = s32 * (a * b[labels]).sum(dim=-1)
    return (lse - pos).mean()


def chunked_clip_pair_loss(image_embed: torch.Tensor,
                           text_embed: torch.Tensor, scale: torch.Tensor,
                           axis_name=None, chunk_size: int = 1024
                           ) -> torch.Tensor:
    """Memory-bounded symmetric InfoNCE: ``clip_pair_loss``'s value
    without its [B, GB] logits."""
    g_img = gather_features(image_embed, axis_name)
    g_txt = gather_features(text_embed, axis_name)
    labels = infonce_labels(image_embed.shape[0], axis_name,
                            device=image_embed.device)
    li = chunked_cross_entropy(image_embed, g_txt, scale, labels, chunk_size)
    lt = chunked_cross_entropy(text_embed, g_img, scale, labels, chunk_size)
    return (li + lt) / 2


def _ring(blk: torch.Tensor, carry, tile_fn, axis_name):
    """The flat ring (``_nested_ring`` of the JAX package over one axis):
    ``tile_fn(carry, blk, first)`` folds each of the W blocks, this rank's
    own first (``first``: the positives' tile), the block moving one rank
    on between tiles. JAX's W-th hop, which only brings the block home,
    is not made."""
    if isinstance(axis_name, (tuple, list)):
        raise NotImplementedError(
            "the multi-slice ring over a tuple of axes is not ported "
            "(ROADMAP.md item 1.10)")
    w = 1 if axis_name is None else axis_name.size
    for step in range(w):
        carry = tile_fn(carry, blk, step == 0)
        if step + 1 < w:
            blk = _Shift.apply(blk, axis_name)
    return carry


def ring_cross_entropy(feat_a: torch.Tensor, feat_b_local: torch.Tensor,
                       scale: torch.Tensor, axis_name) -> torch.Tensor:
    """Gather-free ring InfoNCE CE (contrastive.py:237-283 of the JAX
    package): each of the W tiles [B, B] folds into a running
    log-sum-exp; the positives sit on the diagonal of this rank's own
    tile."""
    a = feat_a.float()
    s32 = scale.float()

    def tile(carry, blk, first):
        m, s, pos = carry
        logits = s32 * torch.matmul(a, blk.float().t())
        new_m = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=-1)
        if first:
            pos = torch.diagonal(logits)
        return new_m, s, pos

    n = a.shape[0]
    init = (a.new_full((n,), -float("inf")), a.new_zeros((n,)),
            a.new_zeros((n,)))
    m, s, pos = _ring(feat_b_local, init, tile, axis_name)
    return (m + torch.log(s) - pos).mean()


def ring_clip_pair_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                        scale: torch.Tensor, axis_name) -> torch.Tensor:
    """Symmetric ring InfoNCE: the gather-free CLIP loss."""
    li = ring_cross_entropy(image_embed, text_embed, scale, axis_name)
    lt = ring_cross_entropy(text_embed, image_embed, scale, axis_name)
    return (li + lt) / 2


def split_scale(scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pair-loss protocol passes ``scale`` bare or as a ``(scale,
    logit_bias)`` tuple (method_losses.pair_scale); -> (scale, bias), the
    bias 0 where there is none."""
    if isinstance(scale, tuple):
        s, b = scale
        return s, torch.as_tensor(b, dtype=torch.float32, device=s.device)
    return scale, torch.zeros((), device=scale.device)


def _sigmoid_terms(logits: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Each row's sum of ``-log sigmoid(z * logits)``."""
    return -F.logsigmoid(z * logits).sum(dim=-1)


def sigmoid_pair_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                      scale, axis_name=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SigLIP's pairwise sigmoid loss (Zhai et al. 2023; contrastive.py:
    318-342 of the JAX package): ``-1/B sum_ij log sigmoid(z_ij (scale
    x_i . y_j + bias))``, z +1 on the matched pairs and -1 elsewhere, over
    the gathered text side. -> (loss, logits, labels)."""
    s, bias = split_scale(scale)
    g_txt = gather_features(text_embed, axis_name)
    logits = similarity_logits(image_embed, g_txt, s) + bias
    labels = infonce_labels(image_embed.shape[0], axis_name,
                            device=image_embed.device)
    z = 2.0 * F.one_hot(labels, logits.shape[1]).float() - 1.0
    return _sigmoid_terms(logits, z).mean(), logits, labels


def chunked_sigmoid_pair_loss(image_embed: torch.Tensor,
                              text_embed: torch.Tensor, scale,
                              axis_name=None, chunk_size: int = 1024
                              ) -> torch.Tensor:
    """The sigmoid loss over column chunks of the gathered text side, each
    chunk's body checkpointed as in ``chunked_cross_entropy``; exact, the
    loss being a plain sum over pairs."""
    s, bias = split_scale(scale)
    a = image_embed.float()
    b = gather_features(text_embed, axis_name).float()
    s32 = s.float()
    labels = infonce_labels(a.shape[0], axis_name, device=a.device)
    gb = b.shape[0]
    c = min(int(chunk_size), gb)

    def body(acc, blk, beg):
        logits = s32 * torch.matmul(a, blk.t()) + bias
        col = beg + torch.arange(blk.shape[0], device=a.device)
        z = torch.where(col[None, :] == labels[:, None], 1.0, -1.0)
        return acc + _sigmoid_terms(logits, z)

    acc = a.new_zeros((a.shape[0],))
    for beg in range(0, gb, c):
        acc = checkpoint(body, acc, b[beg:beg + c], beg, use_reentrant=False)
    return acc.mean()


def ring_sigmoid_pair_loss(image_embed: torch.Tensor,
                           text_embed: torch.Tensor, scale,
                           axis_name) -> torch.Tensor:
    """The gather-free ring sigmoid loss (contrastive.py:385-411 of the
    JAX package), the SigLIP paper's device schedule: each of the W tiles
    adds its pairs' terms, the positives on the diagonal of this rank's
    own tile; no normalizer, so no running carry beyond the sum."""
    s, bias = split_scale(scale)
    a = image_embed.float()
    s32 = s.float()
    n = a.shape[0]
    eye = torch.eye(n, device=a.device)

    def tile(acc, blk, first):
        logits = s32 * torch.matmul(a, blk.float().t()) + bias
        z = 2.0 * eye - 1.0 if first else -torch.ones_like(logits)
        return acc + _sigmoid_terms(logits, z)

    acc = _ring(text_embed, a.new_zeros((n,)), tile, axis_name)
    return acc.mean()


_KINDS = ("full", "chunked", "ring", "sigmoid", "sigmoid_chunked",
          "sigmoid_ring")


def loss_impl_kind(cfg) -> str:
    """The configured contrastive-loss implementation: ``loss_impl: {type:
    full|chunked|ring|sigmoid|sigmoid_chunked|sigmoid_ring}`` (or a bare
    string). Default 'full'."""
    node = (cfg or {}).get("loss_impl") or {}
    if isinstance(node, str):
        node = {"type": node}
    return str(node.get("type", "full"))


def make_pair_loss(cfg, *, axis_name=None):
    """Config-selected pair loss (contrastive.py:426-555 of the JAX
    package): ``pair_loss(img, txt, scale) -> (loss, logits_for_acc,
    labels_for_acc)``, ``scale`` bare or ``(scale, logit_bias)``; the
    softmax kinds ignore the bias. The chunked and ring kinds report their
    accuracy on a proxy block, the first ``acc_window`` rows against the
    first ``acc_window`` local columns (the meter, not the objective).
    ``loss_impl``'s ``chunk_size`` (1024) and ``acc_window`` (1024) are
    read. The ring kinds return each rank's mean over its own rows, as
    every kind here does; JAX's ``pmean`` of it is the train step's mean
    over the ranks."""
    kind = loss_impl_kind(cfg)
    node = (cfg or {}).get("loss_impl") or {}
    if isinstance(node, str):
        node = {}
    chunk = int(node.get("chunk_size", 1024))
    acc_k = int(node.get("acc_window", 1024))
    if kind not in _KINDS:
        raise NotImplementedError(f"loss_impl type {kind!r}")
    if isinstance(axis_name, (tuple, list)):
        raise NotImplementedError(
            "a loss over a tuple of axes (the multi-slice ring) is not "
            "ported (ROADMAP.md item 1.10)")

    def acc_proxy(img, txt, scale):
        s, _ = split_scale(scale)
        k = min(img.shape[0], acc_k)
        return (similarity_logits(img[:k], txt[:k], s),
                torch.arange(k, device=img.device))

    def pair(img, txt, scale):
        s, _ = split_scale(scale)
        if kind == "full":
            return clip_pair_loss(img, txt, s, axis_name)
        if kind == "sigmoid":
            return sigmoid_pair_loss(img, txt, scale, axis_name)
        if kind == "chunked":
            loss = chunked_clip_pair_loss(img, txt, s, axis_name, chunk)
        elif kind == "ring":
            loss = ring_clip_pair_loss(img, txt, s, axis_name)
        elif kind == "sigmoid_chunked":
            loss = chunked_sigmoid_pair_loss(img, txt, scale, axis_name,
                                             chunk)
        else:
            loss = ring_sigmoid_pair_loss(img, txt, scale, axis_name)
        return (loss, *acc_proxy(img, txt, scale))

    return pair


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Tuple[int, ...] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracies in percent (reference accuracy(), misc.py); ties go
    to the lower index, as a stable descending sort gives them."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    return tuple(
        100.0 * (order[:, :k] == labels[:, None]).any(dim=-1).float().mean()
        for k in ks)
