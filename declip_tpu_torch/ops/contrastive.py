"""Global-batch contrastive logits + InfoNCE (port of
declip_tpu/ops/contrastive.py, the ``full`` mode).

The reference's gathered-feature InfoNCE (prototype/model/clip.py:25-49,
136-144, prototype/loss_functions/loss.py:24-47). ``axis_name`` is the data
group (``parallel.Group``) or None for one process. Over a group each rank
holds its own [B, D] rows: ``gather_features`` is a differentiable
all-gather in rank order, whose backward sums the gathered gradient over
the ranks and keeps this rank's rows (the reference's AllGather.backward,
clip.py:42-49; JAX's psum_scatter), and the labels are ``rank * B +
arange(B)``. Each rank's loss is then the mean over its own rows, and the
train step's mean of the gradients over the ranks is the gradient of the
global batch's loss. The chunked, ring and sigmoid loss modes are not
ported (ROADMAP.md item 1.10).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from declip_tpu_torch.parallel import comms

_NOT_PORTED = "not ported yet (ROADMAP.md item 1.10, distribution)"


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


def loss_impl_kind(cfg) -> str:
    """The configured contrastive-loss implementation: ``loss_impl: {type:
    full|chunked|ring|...}`` (or a bare string). Default 'full'."""
    node = (cfg or {}).get("loss_impl") or {}
    if isinstance(node, str):
        node = {"type": node}
    return str(node.get("type", "full"))


def make_pair_loss(cfg, *, axis_name=None):
    """Config-selected symmetric InfoNCE: ``pair_loss(img, txt, scale) ->
    (loss, logits_for_acc, labels_for_acc)``. Only ``full`` (gathered
    [B, GB] logits, clip.py:136-144) is ported."""
    kind = loss_impl_kind(cfg)
    if kind != "full":
        raise NotImplementedError(f"loss_impl type {kind!r}: {_NOT_PORTED}")

    def pair(img, txt, scale):
        return clip_pair_loss(img, txt, scale, axis_name)

    return pair


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Tuple[int, ...] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracies in percent (reference accuracy(), misc.py); ties go
    to the lower index, as a stable descending sort gives them."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    return tuple(
        100.0 * (order[:, :k] == labels[:, None]).any(dim=-1).float().mean()
        for k in ks)
