"""Per-method training loss assembly (port of
declip_tpu/train/method_losses.py; CLIP only so far).

Each function takes the model's feature dict and returns
``(total_loss, metrics)``. Losses are per-row means, as in the JAX package
(no division by the world size).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from declip_tpu_torch.ops.contrastive import make_pair_loss, topk_accuracy

Metrics = Dict[str, torch.Tensor]


def clip_losses(out: Dict[str, Any], cfg: Dict, axis_name: Optional[str],
                pair_loss=None) -> Tuple[torch.Tensor, Metrics]:
    """clip_solver.py:407-430: single symmetric InfoNCE.

    pair_loss: the config-selected implementation (make_pair_loss); built
    from cfg when the train step does not supply it."""
    if "logit_bias" in out:
        raise NotImplementedError(
            "a model with a logit_bias (logit_bias_init) trains with the "
            "sigmoid loss, not ported yet (ROADMAP.md item 1.10)")
    if pair_loss is None:
        pair_loss = make_pair_loss(cfg, axis_name=axis_name)
    loss, logits_i, labels = pair_loss(
        out["image_embed"], out["text_embed"], out["logit_scale"])
    top1, top5 = topk_accuracy(logits_i, labels)
    metrics = {"loss": loss, "clip_loss": loss, "top1": top1, "top5": top5,
               "logit_scale": out["logit_scale"]}
    return loss, metrics
