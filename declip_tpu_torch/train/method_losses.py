"""Per-method training loss assembly (port of
declip_tpu/train/method_losses.py: CLIP, SLIP, FILIP, DeCLIP and DeFILIP,
and the SSL builders' SimCLR and MoCo/CLSA losses).

Each function takes the model's feature dict and returns
``(total_loss, metrics)``. Losses are per-row means, as in the JAX package
(no division by the world size). ``axis_name``: the data group
(``parallel.Group``) or None for one process. Over a group each rank holds
its own rows of the global batch, every global-batch term runs over the
gathered features (ops/contrastive.py), and the MLM loss is normalised by
the global count of masked tokens, so that the mean over the ranks of
their losses is the JAX solver's loss on the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from declip_tpu_torch.losses import (
    mlm_loss,
    nt_xent,
    nt_xent_convirt,
    nt_xent_gather,
    simsiam_loss,
)
from declip_tpu_torch.ops.contrastive import (
    chunked_cross_entropy,
    clip_infonce,
    gather_features,
    infonce_labels,
    loss_impl_kind,
    make_pair_loss,
    similarity_logits,
    topk_accuracy,
)
from declip_tpu_torch.ops.filip_ops import dispatch_late_interaction

Metrics = Dict[str, torch.Tensor]


def _pair_scale(out: Dict[str, Any]):
    """The pair loss's scale argument (method_losses.py:37-44 of the JAX
    package): a model built with a SigLIP ``logit_bias`` (``clip:
    {logit_bias_init: ...}``) puts it in its outputs, and it travels as a
    ``(scale, bias)`` tuple, which the sigmoid kinds unpack and the
    softmax kinds ignore."""
    if "logit_bias" in out:
        return (out["logit_scale"], out["logit_bias"])
    return out["logit_scale"]


def clip_losses(out: Dict[str, Any], cfg: Dict, axis_name: Optional[str],
                pair_loss=None) -> Tuple[torch.Tensor, Metrics]:
    """clip_solver.py:407-430: single symmetric InfoNCE (or the configured
    ``loss_impl``), with ``logit_bias`` among the metrics where the model
    has one.

    pair_loss: the config-selected implementation (make_pair_loss); built
    from cfg when the train step does not supply it."""
    if pair_loss is None:
        pair_loss = make_pair_loss(cfg, axis_name=axis_name)
    loss, logits_i, labels = pair_loss(
        out["image_embed"], out["text_embed"], _pair_scale(out))
    top1, top5 = topk_accuracy(logits_i, labels)
    metrics = {"loss": loss, "clip_loss": loss, "top1": top1, "top5": top5,
               "logit_scale": out["logit_scale"]}
    if "logit_bias" in out:
        # a copy: the model's output is a view of the parameter, which the
        # step's update then changes in place; the metric is the bias the
        # forward used, as JAX's
        metrics["logit_bias"] = out["logit_bias"].detach().clone()
    return loss, metrics


def slip_losses(out: Dict[str, Any], cfg: Dict, axis_name: Optional[str],
                pair_loss=None) -> Tuple[torch.Tensor, Metrics]:
    """slip_solver.py:478-512: CLIP plus the gathered SimCLR NT-Xent
    (temperature 0.1) of the two strong views, weighted by the config's
    ``loss_weight`` (``clip_loss``, ``simclr_loss``; 1 each by default)."""
    w = cfg.get("loss_weight") or {}
    clip_l, metrics = clip_losses(out, cfg, axis_name, pair_loss)
    sim1, sim2 = out["image_sim_1"], out["image_sim_2"]
    labels = infonce_labels(sim1.shape[0], axis_name, device=sim1.device)
    simclr = nt_xent_gather(sim1, gather_features(sim1, axis_name), sim2,
                            gather_features(sim2, axis_name), labels,
                            temperature=0.1)
    total = (clip_l * w.get("clip_loss", 1.0)
             + simclr * w.get("simclr_loss", 1.0))
    metrics.update({"loss": total, "simclr_loss": simclr})
    return total, metrics


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
    clip_loss, logits_i, labels_acc = pair_loss(img, txt, _pair_scale(out))

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

    mlm = (mlm_loss(out["mlm_logits"], out["mlm_labels"], axis_name)
           if "mlm_logits" in out else torch.zeros((), device=img.device))

    total = clip_loss * w.get("clip_loss", 1.0)
    total = total + dense_loss * w.get("clip_dense_loss", 0.0)
    total = total + mlm * w.get("masking_language", 0.0)

    top1, top5 = topk_accuracy(logits_i, labels_acc)
    return total, {"loss": total, "clip_loss": clip_loss,
                   "clip_dense_loss": dense_loss, "text_mlm_loss": mlm,
                   "top1": top1, "top5": top5,
                   "logit_scale": out["logit_scale"]}


def _declip_clip_terms(out, cfg, pair_loss):
    """The 2x2 view x (text, text_aug) CLIP losses (declip_solver.py:
    442-452): the mean of the four, or of the two on the main captions
    under ``data.train.only_image_two_view``."""
    scale = _pair_scale(out)
    i1, i2 = out["image_embed_1"], out["image_embed_2"]
    t, ta = out["text_embed"], out["text_embed_aug"]
    l1, logits_i1, labels_acc = pair_loss(i1, t, scale)
    l2, _, _ = pair_loss(i2, t, scale)
    data_cfg = ((cfg or {}).get("data") or {}).get("train") or {}
    if data_cfg.get("only_image_two_view", False):
        return (l1 + l2) / 2, logits_i1, labels_acc
    l1a, _, _ = pair_loss(i1, ta, scale)
    l2a, _, _ = pair_loss(i2, ta, scale)
    return (l1 + l2 + l1a + l2a) / 4, logits_i1, labels_acc


def declip_losses(out: Dict[str, Any], cfg: Dict, axis_name: Optional[str],
                  *, nn_text=None, nn_text_aug=None, nn_simsiam=None,
                  step: int = 0, total_steps: int = 1, pair_loss=None
                  ) -> Tuple[torch.Tensor, Metrics]:
    """declip_solver.py:442-533: the CLIP terms, image SimSiam, MLM, text
    SimSiam, the InfoNCE of the images against the NN-bank neighbours of
    both captions, and nn-SimSiam, weighted by ``clip_simsiam_loss_weight``
    and its ``type``: None (each term by its weight), ``convirt`` (CLIP with
    ConVIRT's NT-Xent, plus SimSiam), ``linear`` (CLIP's weight 0.2 -> 1.0
    over ``total_steps``, SimSiam the rest) or ``shift`` (CLIP on even
    steps, SimSiam on odd ones).

    nn_text / nn_text_aug: tuples of [B, D] bank neighbours (normalized by
    the caller), or None without the bank; nn_simsiam: (the predictor's
    output on the text, the projected neighbours) or None."""
    w = dict(cfg.get("clip_simsiam_loss_weight") or {})
    if pair_loss is None:
        pair_loss = make_pair_loss(cfg, axis_name=axis_name)
    clip_loss, logits_i1, labels_acc = _declip_clip_terms(out, cfg, pair_loss)
    device = clip_loss.device
    zero = torch.zeros((), device=device)

    simsiam = simsiam_loss(*out["simsiam"])
    mlm = (mlm_loss(out["mlm_logits"], out["mlm_labels"], axis_name)
           if "mlm_logits" in out else zero)
    text_simsiam = (simsiam_loss(*out["text_simsiam"])
                    if "text_simsiam" in out else zero)
    nn_simsiam_loss = zero
    if nn_simsiam is not None:
        p_text, z_nn = nn_simsiam
        nn_simsiam_loss = simsiam_loss(p_text, z_nn[0], p_text, z_nn[0])

    clip_nn_text = zero
    if nn_text is not None:
        # image vs NN(text) and vs NN(text_aug) logits through symmetric
        # InfoNCE, as the reference pairs them (declip_solver.py:474-482);
        # the gathered neighbours' columns in rank order, the labels this
        # rank's rows
        scale = out["logit_scale"]
        i1, i2 = out["image_embed_1"], out["image_embed_2"]
        labels = infonce_labels(i1.shape[0], axis_name, device=device)
        g_nn = torch.cat([gather_features(t, axis_name) for t in nn_text])
        g_nn_aug = torch.cat([gather_features(t, axis_name)
                              for t in nn_text_aug])
        if loss_impl_kind(cfg) == "full":
            l_nn1 = clip_infonce(similarity_logits(i1, g_nn, scale),
                                 similarity_logits(i1, g_nn_aug, scale),
                                 labels)
            l_nn2 = clip_infonce(similarity_logits(i2, g_nn, scale),
                                 similarity_logits(i2, g_nn_aug, scale),
                                 labels)
        else:
            # every other kind, the sigmoid ones too: the blockwise
            # softmax log-sum-exp over the bank's keys, which are query
            # results and not batch rows, so no ring turns them (JAX
            # method_losses.py:150-166, its default chunk of 1024)
            def ce(a, b):
                return chunked_cross_entropy(a, b, scale, labels)

            l_nn1 = (ce(i1, g_nn) + ce(i1, g_nn_aug)) / 2
            l_nn2 = (ce(i2, g_nn) + ce(i2, g_nn_aug)) / 2
        clip_nn_text = (l_nn1 + l_nn2) / 2

    wtype = w.get("type")
    metrics: Metrics = {}
    if wtype is None:
        total = clip_loss * w.get("clip_loss", 1.0)
        total = total + simsiam * w.get("simsiam_loss", 0.0)
        total = total + mlm * w.get("masking_language", 0.0)
        total = total + text_simsiam * w.get("text_simsiam_loss", 0.0)
        total = total + clip_nn_text * w.get("nn_text", 0.0)
        total = total + nn_simsiam_loss * w.get("nn_simsiam_loss", 0.0)
    elif wtype == "convirt":
        ntx = (nt_xent_convirt(out["image_embed_1"], out["text_embed"],
                               axis_name=axis_name)
               + nt_xent_convirt(out["image_embed_2"], out["text_embed"],
                                 axis_name=axis_name))
        total = (clip_loss + ntx) / 2 * w.get("clip_loss", 1.0)
        total = total + simsiam * w.get("simsiam_loss", 0.0)
        metrics["nt_xent_loss"] = ntx
    elif wtype == "linear":
        # fp32, as the JAX package computes the weight
        cw = 0.2 + 0.8 * (torch.tensor(float(step), dtype=torch.float32)
                          / max(total_steps, 1))
        cw = cw.to(device)
        total = clip_loss * cw + simsiam * (1.0 - cw)
    elif wtype == "shift":
        total = clip_loss if step % 2 == 0 else simsiam
    else:
        raise NotImplementedError(f"loss weight type {wtype!r}")

    top1, top5 = topk_accuracy(logits_i1, labels_acc)
    metrics.update({
        "loss": total, "clip_loss": clip_loss, "simsiam_loss": simsiam,
        "text_mlm_loss": mlm, "clip_nn_text_loss": clip_nn_text,
        "text_simsiam_loss": text_simsiam, "top1": top1, "top5": top5,
        "logit_scale": out["logit_scale"]})
    return total, metrics


def defilip_losses(out: Dict[str, Any], cfg: Dict, axis_name: Optional[str],
                   *, nn_text=None, nn_text_aug=None, nn_simsiam=None,
                   step: int = 0, total_steps: int = 1, pair_loss=None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """defilip_solver.py:462-543: the DeCLIP assembly (``declip_losses``,
    bank inputs included) plus the ``filip`` term, the symmetric InfoNCE of
    the late interaction of each side's full tokens against the other
    side's gathered top-k selection. Under ``dense_aug`` it is the mean of
    the four (image view, caption) pairings, each with its own selections.
    The term joins the total only under weight type None
    (defilip_solver.py:541-543); ``filip_loss`` is reported under every
    type."""
    w = dict(cfg.get("clip_simsiam_loss_weight") or {})
    total, metrics = declip_losses(
        out, cfg, axis_name, nn_text=nn_text, nn_text_aug=nn_text_aug,
        nn_simsiam=nn_simsiam, step=step, total_steps=total_steps,
        pair_loss=pair_loss)
    filip_loss = torch.zeros((), device=total.device)
    if "dense_image_1" in out:
        late_interaction = dispatch_late_interaction(cfg)
        ds = out["logit_scale_dense"]
        labels = infonce_labels(out["image_embed_1"].shape[0], axis_name,
                                device=total.device)

        def term(q_img, q_txt, sel_img, sel_txt):
            return clip_infonce(
                late_interaction(q_img, gather_features(sel_txt, axis_name),
                                 ds),
                late_interaction(q_txt, gather_features(sel_img, axis_name),
                                 ds), labels)

        d_i1, d_t = out["dense_image_1"], out["dense_text"]
        filip_loss = term(d_i1, d_t, out["dense_image_1_sel"],
                          out["dense_text_sel"])
        if "dense_image_2" in out:  # dense_aug (defilip.py:336-339)
            d_i2, d_ta = out["dense_image_2"], out["dense_text_aug"]
            aug = sum(term(q_img, q_txt, *out[key])
                      for q_img, q_txt, key in (
                          (d_i2, d_t, "dense_sel_i2_t"),
                          (d_i1, d_ta, "dense_sel_i1_ta"),
                          (d_i2, d_ta, "dense_sel_i2_ta")))
            filip_loss = (filip_loss + aug) / 4
    if w.get("type") is None:
        total = total + filip_loss * w.get("filip", 0.0)
    metrics.update({"loss": total, "filip_loss": filip_loss})
    return total, metrics


def simclr_losses(out: Dict[str, Any], axis_name: Optional[str], *,
                  temperature: float = 0.5) -> Tuple[torch.Tensor, Metrics]:
    """SimCLR's NT-Xent over the two weak views (simclr_builder.py; JAX
    method_losses.py:304-317): the local NT-Xent with one process, this
    rank's rows against the gathered views over a group."""
    z1, z2 = out["q"], out["z2"]
    if axis_name is None:
        total = nt_xent(z1, z2, temperature)
    else:
        labels = infonce_labels(z1.shape[0], axis_name, device=z1.device)
        total = nt_xent_gather(z1, gather_features(z1, axis_name), z2,
                               gather_features(z2, axis_name), labels,
                               temperature)
    return total, {"loss": total, "simclr_loss": total}


def moco_losses(out: Dict[str, Any], *, k: torch.Tensor,
                queue: torch.Tensor, temperature: float = 0.07,
                clsa_ratio: float = 1.0, clsa_avg: bool = True
                ) -> Tuple[torch.Tensor, Metrics]:
    """MoCo's InfoNCE of the queries against their keys and the queue's
    negatives, and CLSA's DDM terms on the strong views where ``out`` has
    them (moco_builder.py:133-161, clsa_builder.py:110-180; JAX
    method_losses.py:320-357). Every term is a mean over this rank's rows,
    so that the mean over the ranks is the global batch's."""
    q = out["q"]

    def logits_of(feats):
        l_pos = (feats * k).sum(dim=-1, keepdim=True)
        l_neg = feats.float() @ queue.float().t()
        return torch.cat([l_pos, l_neg], dim=1).float() / temperature

    logits_weak = logits_of(q)
    logp = torch.log_softmax(logits_weak, dim=-1)
    contrastive = -logp[:, 0].mean()

    ddm = torch.zeros((), device=q.device)
    strong = out.get("q_strong", ())
    if strong:
        # -P(weak) . log P(strong) per strong view (clsa_builder.py:158-172),
        # with the gradient through P(weak) too, as the reference has it
        p_weak = torch.softmax(logits_weak, dim=-1)
        for q_s in strong:
            logp_s = torch.log_softmax(logits_of(q_s), dim=-1)
            ddm = ddm - (p_weak * logp_s).sum(dim=-1).mean()

    total = contrastive + clsa_ratio * ddm
    if strong and clsa_avg:  # clsa_builder.py:174-176
        total = total / (len(strong) + 1)
    top1 = 100.0 * (logits_weak.argmax(dim=-1) == 0).float().mean()
    metrics = {"loss": total, "moco_loss": contrastive, "top1": top1}
    if strong:
        metrics["ddm_loss"] = ddm
    return total, metrics
