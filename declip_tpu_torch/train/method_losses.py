"""Per-method training loss assembly (port of
declip_tpu/train/method_losses.py; CLIP and FILIP so far).

Each function takes the model's feature dict and returns
``(total_loss, metrics)``. Losses are per-row means, as in the JAX package
(no division by the world size).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from declip_tpu_torch.losses import mlm_loss
from declip_tpu_torch.ops.contrastive import (
    clip_infonce,
    gather_features,
    infonce_labels,
    make_pair_loss,
    topk_accuracy,
)
from declip_tpu_torch.ops.filip_ops import dispatch_late_interaction

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


def filip_losses(out: Dict[str, Any], cfg: Dict, axis_name: Optional[str],
                 pair_loss=None) -> Tuple[torch.Tensor, Metrics]:
    """filip_solver.py:470-523: the CLIP loss, the dense late-interaction
    loss and the MLM loss, weighted by ``clip_simsiam_loss_weight`` with the
    reference's defaults (clip_loss 1, clip_dense_loss 0,
    masking_language 0). A term of weight 0 still runs, and the parameters
    only it reaches get a gradient of exactly zero (they decay all the
    same), as in the JAX package."""
    w = dict(cfg.get("clip_simsiam_loss_weight") or {})
    if pair_loss is None:
        pair_loss = make_pair_loss(cfg, axis_name=axis_name)
    img, txt = out["image_embed"], out["text_embed"]
    clip_loss, logits_i, labels_acc = pair_loss(img, txt, out["logit_scale"])

    dense_loss = torch.zeros((), device=img.device)
    if "dense_image" in out:
        # the query side uses all its own tokens; the gathered side is the
        # top-k selection (filip.py:92-105 gathers selected_feat only)
        late_interaction = dispatch_late_interaction(cfg)
        ds = out["logit_scale_dense"]
        g_di = gather_features(out["dense_image_sel"], axis_name)
        g_dt = gather_features(out["dense_text_sel"], axis_name)
        logits_di = late_interaction(out["dense_image"], g_dt, ds)
        logits_dt = late_interaction(out["dense_text"], g_di, ds)
        labels = infonce_labels(img.shape[0], axis_name, device=img.device)
        dense_loss = clip_infonce(logits_di, logits_dt, labels)

    mlm = (mlm_loss(out["mlm_logits"], out["mlm_labels"])
           if "mlm_logits" in out else torch.zeros((), device=img.device))

    total = clip_loss * w.get("clip_loss", 1.0)
    total = total + dense_loss * w.get("clip_dense_loss", 0.0)
    total = total + mlm * w.get("masking_language", 0.0)

    top1, top5 = topk_accuracy(logits_i, labels_acc)
    return total, {"loss": total, "clip_loss": clip_loss,
                   "clip_dense_loss": dense_loss, "text_mlm_loss": mlm,
                   "top1": top1, "top5": top5,
                   "logit_scale": out["logit_scale"]}
