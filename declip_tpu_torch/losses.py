"""Reference losses in plain torch (port of declip_tpu/losses.py: label
smoothing, the masked-language-model, SimSiam, SimCLR NT-Xent (local and
gathered) and ConVIRT NT-Xent losses)."""

from __future__ import annotations

import torch

from declip_tpu_torch.ops.contrastive import (
    cross_entropy,
    gather_features,
    infonce_labels,
)
from declip_tpu_torch.parallel import comms
from declip_tpu_torch.tokenizer.mlm import IGNORE_INDEX


def label_smooth_ce(logits: torch.Tensor, labels: torch.Tensor,
                    smooth_ratio: float, num_classes: int) -> torch.Tensor:
    """LabelSmoothCELoss (loss.py:7-21; JAX losses.py:19-28): the target
    puts ``1 - smooth_ratio + smooth_ratio / num_classes`` on the label and
    ``smooth_ratio / num_classes`` elsewhere; fp32 log-softmax, summed over
    classes and averaged over rows."""
    v = smooth_ratio / num_classes
    target = torch.full(logits.shape, v, dtype=torch.float32,
                        device=logits.device)
    target[torch.arange(logits.shape[0], device=logits.device),
           labels.long()] = 1 - smooth_ratio + v
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp * target).sum() / logits.shape[0]


def _unit(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _cosine(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (_unit(p) * _unit(z)).sum(dim=-1).mean()


def simsiam_loss(p1, z1, p2, z2) -> torch.Tensor:
    """Symmetric negative cosine with stop-gradient on z (SimsiamLoss,
    loss.py:49-81; JAX losses.py:37-43), in the features' dtype."""
    z1, z2 = z1.detach(), z2.detach()
    return -0.5 * (_cosine(p1, z2) + _cosine(p2, z1))


def simsiam_loss_minimize(p: torch.Tensor,
                          z_candidates: torch.Tensor) -> torch.Tensor:
    """D_minimize (loss.py:57-62): the mean over rows of the largest
    cosine over the candidate axis. p [B, D], z_candidates [B, K, D]
    (stop-gradient)."""
    sim = torch.einsum("bd,bkd->bk", _unit(p), _unit(z_candidates.detach()))
    return sim.max(dim=-1).values.mean()


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             axis_name=None) -> torch.Tensor:
    """Masked-token CE ignoring -100 (declip.py:326-334; JAX losses.py:55-67).

    logits [B, L, V], labels int [B, L]. fp32 log-softmax; the mean over the
    selected positions, and 0 when a batch selects none (the reference would
    give NaN there). Over a group (``axis_name``) the count of selected
    positions is the global batch's, shared out over the ranks, so that the
    mean of the ranks' losses is the global batch's mean."""
    mask = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, 0, labels).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count = mask.sum()
    if axis_name is None:
        return (nll * mask).sum() / torch.clamp(count, min=1.0)
    count = comms.all_reduce_(count.detach().clone(), axis_name)
    return (nll * mask).sum() / (torch.clamp(count, min=1.0)
                                 / axis_name.size)


def nt_xent_convirt(zis: torch.Tensor, zjs: torch.Tensor,
                    temperature: float = 0.1, alpha: float = 0.75,
                    norm: bool = True, axis_name=None) -> torch.Tensor:
    """ConVIRT's image-text NT-Xent (nt_xent_ConVIRT.py:4-86; JAX
    losses.py:129-147): alpha CE(image -> text) + (1 - alpha) CE(text ->
    image) over the batch, fp32 logits; over a group (``axis_name``) this
    rank's rows against the gathered batch, as the JAX solver computes it
    on the global batch."""
    if norm:
        zis, zjs = _unit(zis, 1e-12), _unit(zjs, 1e-12)
    labels = infonce_labels(zis.shape[0], axis_name, device=zis.device)
    g_zis = gather_features(zis, axis_name)
    g_zjs = gather_features(zjs, axis_name)
    loss_a = cross_entropy((zis @ g_zjs.t()).float() / temperature, labels)
    loss_b = cross_entropy((zjs @ g_zis.t()).float() / temperature, labels)
    return alpha * loss_a + (1 - alpha) * loss_b


def _nt_xent_ce(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """CE with the positive in column 0 against all negatives (``neg``
    -inf where masked out), averaged over rows."""
    denom = torch.logaddexp(pos, torch.logsumexp(neg, dim=-1))
    return (denom - pos).mean()


def nt_xent(z_i: torch.Tensor, z_j: torch.Tensor,
            temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent over the local batch (nt_xent.py:6-44; JAX
    losses.py:70-91): +1e-12 norms, the similarities in the features' dtype
    and then fp32, each row's positive the other view of its image."""
    b = z_i.shape[0]
    p = _unit(torch.cat([z_i, z_j]), 1e-12)
    sim = (p @ p.t()).float() / temperature  # [2B, 2B]
    rows = torch.arange(2 * b, device=p.device)
    pos_idx = torch.cat([rows[b:], rows[:b]])
    pos = sim[rows, pos_idx]
    neg_mask = torch.ones_like(sim, dtype=torch.bool)
    neg_mask[rows, rows] = False
    neg_mask[rows, pos_idx] = False
    return _nt_xent_ce(pos, sim.masked_fill(~neg_mask, float("-inf")))


def nt_xent_gather(z_i: torch.Tensor, z_ib: torch.Tensor, z_j: torch.Tensor,
                   z_jb: torch.Tensor, labels: torch.Tensor,
                   temperature: float = 0.1) -> torch.Tensor:
    """SimCLR against gathered embeddings (NT_Xent_gather, nt_xent.py:47-97;
    JAX losses.py:94-127). z_i, z_j: local views [B, D]; z_ib, z_jb:
    gathered views [GB, D]; labels: this shard's global row offsets
    (``infonce_labels``). Row i of view 1 has gathered view 2's column as
    its positive and vice versa; a row's own two columns are no
    negatives."""
    b, gb = z_i.shape[0], z_ib.shape[0]
    p0 = _unit(torch.cat([z_i, z_j]), 1e-12)  # [2B, D]
    p1 = _unit(torch.cat([z_ib, z_jb]), 1e-12)  # [2GB, D]
    sim = (p0 @ p1.t()).float() / temperature  # [2B, 2GB]
    rows = torch.arange(2 * b, device=sim.device)
    pos = sim[rows, torch.cat([labels + gb, labels])]
    col = torch.arange(2 * gb, device=sim.device)[None, :]
    lab2 = torch.cat([labels, labels])[:, None]
    own = (col == lab2) | (col == lab2 + gb)
    return _nt_xent_ce(pos, sim.masked_fill(own, float("-inf")))
