"""Reference losses in plain torch (port of declip_tpu/losses.py: the
masked-language-model, SimSiam and ConVIRT NT-Xent losses; label smoothing
and the SimCLR NT-Xent come with ROADMAP.md item 1.8)."""

from __future__ import annotations

import torch

from declip_tpu_torch.ops.contrastive import cross_entropy
from declip_tpu_torch.tokenizer.mlm import IGNORE_INDEX


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


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked-token CE ignoring -100 (declip.py:326-334; JAX losses.py:55-67).

    logits [B, L, V], labels int [B, L]. fp32 log-softmax; the mean over the
    selected positions, and 0 when a batch selects none (the reference would
    give NaN there)."""
    mask = (labels != IGNORE_INDEX).float()
    safe = torch.where(labels == IGNORE_INDEX, 0, labels).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def nt_xent_convirt(zis: torch.Tensor, zjs: torch.Tensor,
                    temperature: float = 0.1, alpha: float = 0.75,
                    norm: bool = True) -> torch.Tensor:
    """ConVIRT's image-text NT-Xent (nt_xent_ConVIRT.py:4-86; JAX
    losses.py:129-147): alpha CE(image -> text) + (1 - alpha) CE(text ->
    image) over the local batch, fp32 logits."""
    if norm:
        zis, zjs = _unit(zis, 1e-12), _unit(zjs, 1e-12)
    labels = torch.arange(zis.shape[0], device=zis.device)
    loss_a = cross_entropy((zis @ zjs.t()).float() / temperature, labels)
    loss_b = cross_entropy((zjs @ zis.t()).float() / temperature, labels)
    return alpha * loss_a + (1 - alpha) * loss_b
