"""DeCLIP: CLIP plus two-view image SimSiam, MLM on the captions and the
hooks of the nearest-neighbour text supervision (port of
declip_tpu/models/declip_model.py).

Rebuilds prototype/model/declip.py as the JAX package does: EDA and MLM
masking happen in the data pipeline (the batch carries ``tokens_aug``,
``mlm_tokens`` and ``mlm_labels``), the model returns MLM logits and the
loss layer takes the CE, and the NN memory bank is train-step state
(``models/memory_bank.py``): the model gives the feature dict and the
nn-SimSiam heads, and the train step queries the bank.

BatchNorm (the ResNet tower, the SimSiam heads) takes batch statistics in
training mode and running ones in eval mode; ``project_nn_text`` takes the
running ones whatever the mode, as JAX's ``train=False`` does there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from declip_tpu_torch.models.clip_model import (
    LOGIT_SCALE_INIT,
    LOGIT_SCALE_MAX,
    _l14_defaults,
    build_towers,
    compact_mlm,
    l2_normalize,
)
from declip_tpu_torch.models.heads import PredictionMLP, ProjectionMLP
from declip_tpu_torch.models.layers import (
    as_dtype,
    dense,
    lecun_normal_,
    linear,
)
from declip_tpu_torch.models.resnet import (
    modified_resnet_R50,
    modified_resnet_R101,
)
from declip_tpu_torch.models.text import TextTransformer
from declip_tpu_torch.models.vit import (
    VisualTransformer,
    visual_transformer_B32,
    visual_transformer_L14,
)
from declip_tpu_torch.utils.registry import MODELS


class DECLIP(nn.Module):
    """The JAX package's fields. ``use_allgather``, ``return_dense``,
    ``return_caption`` and ``forward_type`` are accepted and unused, as
    there. ``nn_size`` and ``feature_dim`` size the bank the solver makes,
    and ``EDA`` tells its loader to make EDA captions (the bank itself is
    train state). ``fuse_views`` runs the two text passes, and under
    a ViT the two image views, as one batch each; never a ResNet's views,
    whose BatchNorm statistics are per view (declip.py:225-232), nor a MoE
    tower's, whose capacity couples the batch (declip_model.py:124, 169
    of the JAX package). The heads
    take the towers' embedding widths."""

    def __init__(self, visual: nn.Module, text: nn.Module,
                 use_allgather: bool = True, nn_size: int = 2 ** 16,
                 nn_topk: int = 1, return_dense: bool = False,
                 return_simsiam_text: bool = False,
                 return_simsiam_nn_text: bool = False,
                 return_caption: bool = False, return_nn_bank: bool = False,
                 text_mask_type: Any = None, EDA: bool = True,
                 feature_dim: int = 1024, forward_type: str = "split",
                 mlm_max_positions: int = 24, fuse_views: bool = False,
                 logit_bias_init: Optional[float] = None,
                 logit_scale_init: Optional[float] = None, dtype=None,
                 device=None, **unported):
        super().__init__()
        if unported:  # return_filip among them: DeFILIP's, as in JAX
            raise TypeError(f"{type(self).__name__} got unexpected kwargs "
                            f"{sorted(unported)}")
        self.visual = visual
        self.encode_text = text
        self.use_allgather = use_allgather
        self.nn_size = nn_size
        self.nn_topk = nn_topk
        self.EDA = EDA
        self.feature_dim = feature_dim
        self.return_simsiam_text = return_simsiam_text
        self.return_simsiam_nn_text = return_simsiam_nn_text
        self.return_nn_bank = return_nn_bank
        self.text_mask_type = text_mask_type
        self.mlm_max_positions = mlm_max_positions
        self.fuse_views = fuse_views
        self.dtype = dtype = as_dtype(dtype)
        self.logit_scale_init = (LOGIT_SCALE_INIT if logit_scale_init is None
                                 else logit_scale_init)
        self.logit_scale = nn.Parameter(torch.empty(1, device=device))
        # the SigLIP bias of the sigmoid loss kinds (logit_bias_init)
        self.logit_bias_init = logit_bias_init
        self.logit_bias = (nn.Parameter(torch.empty(1, device=device))
                           if logit_bias_init is not None else None)
        image_dim = visual.embed_dim
        text_dim = text.text_projection.out_features
        self.projector = ProjectionMLP(image_dim, dtype=dtype, device=device)
        self.predictor = PredictionMLP(1024, dtype=dtype, device=device)
        if text_mask_type is not None:
            self.text_label_predictor = linear(
                text.width, text.vocab_size, device)
        if return_simsiam_nn_text:
            self.projector_nn_text = ProjectionMLP(text_dim, dtype=dtype,
                                                   device=device)
            self.predictor_nn_text = PredictionMLP(1024, dtype=dtype,
                                                   device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.visual.init_weights(generator)
        self.encode_text.init_weights(generator)
        nn.init.constant_(self.logit_scale, self.logit_scale_init)
        if self.logit_bias is not None:
            nn.init.constant_(self.logit_bias, self.logit_bias_init)
        heads = [self.projector, self.predictor]
        if self.return_simsiam_nn_text:
            heads += [self.projector_nn_text, self.predictor_nn_text]
        for head in heads:
            head.init_weights(generator)
        if self.text_mask_type is not None:
            lecun_normal_(self.text_label_predictor.weight, generator)
            nn.init.zeros_(self.text_label_predictor.bias)

    def scale_value(self) -> torch.Tensor:
        """exp(s) clamped to <=100 (clip.py:134)."""
        return torch.clamp(torch.exp(self.logit_scale[0]), max=LOGIT_SCALE_MAX)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def _text_pair(self, first: torch.Tensor, second: torch.Tensor,
                   return_dense: bool):
        """The text tower on two token batches: (embed, embed of second)
        and, with ``return_dense``, the first's token features."""
        if self.fuse_views and isinstance(self.encode_text, TextTransformer) \
                and not getattr(self.encode_text, "moe_experts", 0):
            b = first.shape[0]
            out = self.encode_text(torch.cat([first, second]),
                                   return_dense=return_dense)
            if return_dense:
                both, words = out
                return both[:b], both[b:], words[:b]
            return out[:b], out[b:], None
        if return_dense:
            embed, words = self.encode_text(first, return_dense=True)
        else:
            embed, words = self.encode_text(first), None
        return embed, self.encode_text(second), words

    def _mlm_logits(self, out: Dict[str, Any], words: torch.Tensor,
                    labels: torch.Tensor) -> None:
        """The MLM head over the masked main pass's token features."""
        if self.mlm_max_positions and self.mlm_max_positions < words.shape[1]:
            words, labels = compact_mlm(words, labels, self.mlm_max_positions)
        out["mlm_logits"] = dense(words, self.text_label_predictor.weight,
                                  self.text_label_predictor.bias, self.dtype)
        out["mlm_labels"] = labels

    def _image_pair(self, img1: torch.Tensor, img2: torch.Tensor,
                    return_dense: bool = False):
        """The image tower on both views: (out 1, out 2), each the tower's
        output (a tuple with ``return_dense``)."""
        if self.fuse_views and isinstance(self.visual, VisualTransformer) \
                and not getattr(self.visual, "moe_experts", 0):
            b = img1.shape[0]
            both = self.visual(torch.cat([img1, img2]),
                               return_dense=return_dense)
            if return_dense:
                return (both[0][:b], both[1][:b]), (both[0][b:], both[1][b:])
            return both[:b], both[b:]
        return (self.visual(img1, return_dense=return_dense),
                self.visual(img2, return_dense=return_dense))

    def _ssl_heads(self, out: Dict[str, Any], image_embed_1, image_embed_2,
                   text_embed, text_embed_aug) -> None:
        """The SimSiam heads and the normalized embeddings."""
        z1 = self.projector(image_embed_1)
        z2 = self.projector(image_embed_2)
        out["simsiam"] = (self.predictor(z1), z1, self.predictor(z2), z2)

        text_embed = l2_normalize(text_embed, eps=1e-10)
        text_embed_aug = l2_normalize(text_embed_aug, eps=1e-10)
        out["image_embed_1"] = l2_normalize(image_embed_1)
        out["image_embed_2"] = l2_normalize(image_embed_2)
        out["text_embed"] = text_embed
        out["text_embed_aug"] = text_embed_aug
        out["logit_scale"] = self.scale_value()
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias[0]

        if self.return_simsiam_text:
            z1t = self.projector(text_embed)
            z2t = self.projector(text_embed_aug)
            out["text_simsiam"] = (self.predictor(z1t), z1t,
                                   self.predictor(z2t), z2t)
        if self.return_simsiam_nn_text:
            # here, so that the heads' BatchNorm statistics move in the
            # training forward (declip.py:311-314)
            z_text = self.projector_nn_text(text_embed)
            out["nn_simsiam_p_text"] = self.predictor_nn_text(z_text)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        images = batch["images"]  # [B, H, W, 6]: two stacked views, NHWC
        img1, img2 = images[..., :3], images[..., 3:]
        mlm = self.text_mask_type is not None
        out: Dict[str, Any] = {}
        if mlm:
            # the main text pass runs on the MASKED tokens (declip.py:214-216)
            text_embed, text_embed_aug, words = self._text_pair(
                batch["mlm_tokens"], batch["tokens_aug"], True)
            self._mlm_logits(out, words, batch["mlm_labels"])
        else:
            text_embed, text_embed_aug, _ = self._text_pair(
                batch["tokens"], batch["tokens_aug"], False)
        image_embed_1, image_embed_2 = self._image_pair(img1, img2)
        self._ssl_heads(out, image_embed_1, image_embed_2, text_embed,
                        text_embed_aug)
        return out

    def project_nn_text(self, feats: torch.Tensor) -> torch.Tensor:
        """The nn-SimSiam projector over NN-bank query results
        (declip.py:313), applied by the train step, on the running BN
        statistics: bank features move no statistics (a delta from the
        reference, kept from the JAX package)."""
        return self.projector_nn_text(feats, train=False)


def _declip(kwargs: dict, image_factory, device) -> DECLIP:
    visual, text, ck = build_towers(kwargs, image_factory, device)
    ck["dtype"] = kwargs.get("dtype")
    return DECLIP(visual, text, **ck)


@MODELS.register
def declip_res50(device=None, **kwargs) -> DECLIP:
    return _declip(kwargs, modified_resnet_R50, device)


@MODELS.register
def declip_res101(device=None, **kwargs) -> DECLIP:
    return _declip(kwargs, modified_resnet_R101, device)


@MODELS.register
def declip_vitb32(device=None, **kwargs) -> DECLIP:
    return _declip(kwargs, visual_transformer_B32, device)


@MODELS.register
def declip_vitl14(device=None, **kwargs) -> DECLIP:
    return _declip(_l14_defaults(kwargs), visual_transformer_L14, device)
