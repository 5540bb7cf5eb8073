"""DeFILIP: the DeCLIP recipe plus FILIP's token-wise late interaction (port
of declip_tpu/models/defilip_model.py).

Rebuilds prototype/model/defilip.py (declip.py plus the ``return_filip``
dense head, defilip.py:178-183) as the JAX package does:

- the main text pass runs on the MLM-masked tokens when ``text_mask_type``
  is set and gives the dense text; the augmented captions' pass is unmasked
  and gives the dense text otherwise, and the ``dense_aug`` pairings' text
  (defilip.py:290-292, 330-333);
- both image views give dense patch tokens (defilip.py:309-312);
- the primary pairing is view 1 against the text; under ``dense_aug`` the
  three other pairings each take a fresh top-k selection against their own
  other side, as the reference re-ranks tokens inside every
  ``get_weighted_dense_logits`` call (defilip.py:329-339). The late
  interaction itself is the loss's (``train/method_losses.py``).

The DeCLIP parts (the SimSiam heads, MLM, the NN-bank hooks, ``fuse_views``)
are ``DECLIP``'s; the dense heads are FILIP's (``image_mapping``,
``text_mapping``, the shape-``()`` ``logit_scale_dense``, exp with no
clamp).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from declip_tpu_torch.models.clip_model import (
    LOGIT_SCALE_INIT,
    _l14_defaults,
    build_towers,
    l2_normalize,
)
from declip_tpu_torch.models.declip_model import DECLIP
from declip_tpu_torch.models.filip_model import (
    encode_image_dense,
    encode_text_dense,
    topk_token_select,
)
from declip_tpu_torch.models.layers import dense, lecun_normal_, linear
from declip_tpu_torch.models.text import TextTransformer
from declip_tpu_torch.models.vit import (
    visual_transformer_B32,
    visual_transformer_L14,
)
from declip_tpu_torch.utils.registry import MODELS


class DEFILIP(DECLIP):
    """``DECLIP``'s fields plus the JAX package's dense ones.
    ``dense_mapping_image`` / ``dense_mapping_language`` are accepted and
    unused, as there: the mappings take the towers' widths."""

    def __init__(self, visual, text, return_filip: bool = True,
                 dense_embed_dim: int = 256, dense_mapping_image: int = 768,
                 dense_mapping_language: int = 512, dense_aug: bool = False,
                 select_topk: bool = True, top_k: int = 16, device=None,
                 **declip_kwargs):
        super().__init__(visual, text, device=device, **declip_kwargs)
        self.return_filip = return_filip
        self.dense_aug = dense_aug
        self.select_topk = select_topk
        self.top_k = top_k
        if return_filip:
            self.logit_scale_dense = torch.nn.Parameter(
                torch.empty((), device=device))
            self.image_mapping = linear(visual.dense_width, dense_embed_dim,
                                        device)
            self.text_mapping = linear(text.width, dense_embed_dim, device)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        if self.return_filip:
            torch.nn.init.constant_(self.logit_scale_dense, LOGIT_SCALE_INIT)
            for layer in (self.image_mapping, self.text_mapping):
                lecun_normal_(layer.weight, generator)
                torch.nn.init.zeros_(layer.bias)

    def encode_image_dense(self, image: torch.Tensor) -> torch.Tensor:
        return encode_image_dense(self, image)

    def encode_text_dense(self, tokens: torch.Tensor) -> torch.Tensor:
        return encode_text_dense(self, tokens)

    def _text_dense_pair(self, first: torch.Tensor, second: torch.Tensor,
                         first_dense: bool):
        """The text tower on both token batches: (embed, embed of second,
        the first's token features or None, the second's)."""
        if self.fuse_views and isinstance(self.encode_text, TextTransformer) \
                and not getattr(self.encode_text, "moe_experts", 0):
            b = first.shape[0]
            both, words = self.encode_text(torch.cat([first, second]),
                                           return_dense=True)
            return (both[:b], both[b:], words[:b] if first_dense else None,
                    words[b:])
        if first_dense:
            embed, words = self.encode_text(first, return_dense=True)
        else:
            embed, words = self.encode_text(first), None
        embed_aug, words_aug = self.encode_text(second, return_dense=True)
        return embed, embed_aug, words, words_aug

    def _dense(self, layer: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer.weight, layer.bias, self.dtype)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        images = batch["images"]  # [B, H, W, 6]: two stacked views, NHWC
        img1, img2 = images[..., :3], images[..., 3:]
        mlm = self.text_mask_type is not None
        out: Dict[str, Any] = {}
        text_embed, text_embed_aug, words, words_aug = self._text_dense_pair(
            batch["mlm_tokens"] if mlm else batch["tokens"],
            batch["tokens_aug"], mlm)
        if mlm:
            self._mlm_logits(out, words, batch["mlm_labels"])
        if self.return_filip:
            (image_embed_1, image_dense_1), (image_embed_2, image_dense_2) = \
                self._image_pair(img1, img2, return_dense=True)
        else:
            image_embed_1, image_embed_2 = self._image_pair(img1, img2)
        self._ssl_heads(out, image_embed_1, image_embed_2, text_embed,
                        text_embed_aug)
        if not self.return_filip:
            return out

        def sel(a, b):
            return topk_token_select(a, b, self.top_k) if self.select_topk \
                else (a, b)

        d_img_1 = l2_normalize(self._dense(self.image_mapping, image_dense_1))
        d_txt = l2_normalize(self._dense(
            self.text_mapping, words if words is not None else words_aug))
        out["dense_image_1"], out["dense_text"] = d_img_1, d_txt
        # the query side keeps all its tokens; only the gathered (key) side
        # is top-k selected (filip.py:78-105)
        out["dense_image_1_sel"], out["dense_text_sel"] = sel(d_img_1, d_txt)
        if self.dense_aug:
            d_img_2 = l2_normalize(self._dense(self.image_mapping,
                                               image_dense_2))
            d_txt_aug = l2_normalize(self._dense(self.text_mapping,
                                                 words_aug))
            out["dense_image_2"], out["dense_text_aug"] = d_img_2, d_txt_aug
            out["dense_sel_i2_t"] = sel(d_img_2, d_txt)
            out["dense_sel_i1_ta"] = sel(d_img_1, d_txt_aug)
            out["dense_sel_i2_ta"] = sel(d_img_2, d_txt_aug)
        out["logit_scale_dense"] = torch.exp(self.logit_scale_dense)
        return out


def _defilip(kwargs: dict, image_factory, device) -> DEFILIP:
    visual, text, ck = build_towers(kwargs, image_factory, device)
    ck["dtype"] = kwargs.get("dtype")
    return DEFILIP(visual, text, **ck)


@MODELS.register
def defilip_vitb32(device=None, **kwargs) -> DEFILIP:
    return _defilip(kwargs, visual_transformer_B32, device)


@MODELS.register
def defilip_vitl14(device=None, **kwargs) -> DEFILIP:
    return _defilip(_l14_defaults(kwargs), visual_transformer_L14, device)
