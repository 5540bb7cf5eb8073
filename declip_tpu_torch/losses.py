"""Reference losses in plain torch (port of declip_tpu/losses.py; only the
masked-language-model loss so far, the others are ROADMAP.md item 1.1)."""

from __future__ import annotations

import torch

from declip_tpu_torch.tokenizer.mlm import IGNORE_INDEX


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
