"""FILIP model: CLIP plus token-wise late-interaction dense similarity (port
of declip_tpu/models/filip_model.py).

Rebuilds prototype/model/filip.py: linear ``image_mapping`` and
``text_mapping`` heads to ``dense_embed_dim`` (filip.py:40-41), a separate
dense logit scale (filip.py:43-44, ``exp`` with no clamp), and optional
top-k token selection by cross-attention mass (filip.py:78-87). The forward
returns the normalized dense token features; the late-interaction logits
are the loss's business (ops/filip_ops.py, train/method_losses.py).

As in the reference (filip.py:118) the main text forward runs on the MLM-
masked tokens when ``text_mask_type`` is set, and only view 1 of a two-view
image input is used (filip.py:111-112). Parameter names follow the JAX
package's tree, so ``state_from_jax_variables`` carries its weights over.
"""

from __future__ import annotations

from typing import Dict, Optional

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
from declip_tpu_torch.models.layers import (
    as_dtype,
    dense,
    lecun_normal_,
    linear,
)
from declip_tpu_torch.models.resnet import modified_resnet_R50
from declip_tpu_torch.models.vit import (
    visual_transformer_B32,
    visual_transformer_L14,
)
from declip_tpu_torch.utils.registry import MODELS

# knobs of reference dead code that its configs carry (JAX filip_model.py
# l.64-78): accepted and ignored, as there
_COMPAT_KWARGS = ("return_caption", "return_nn_bank", "nn_size", "nn_topk",
                  "EDA", "feature_dim", "embed_dim", "forward_type",
                  "mask_rate", "patch_number", "text_mae_feature",
                  "return_simsiam", "two_view", "sparse")


def topk_token_select(feat_1: torch.Tensor, feat_2: torch.Tensor, k: int):
    """Each side's top-k tokens by total cross-attention mass
    (filip.py:78-87); feats are [B, N, D], already normalized. The order of
    the selected tokens does not change a max over them."""
    cross = torch.einsum("bnd,bmd->bnm", feat_1.float(), feat_2.float())
    id_1 = torch.topk(cross.sum(dim=2), k, dim=1).indices  # [B, k]
    id_2 = torch.topk(cross.sum(dim=1), k, dim=1).indices

    def take(feat, idx):
        return torch.gather(feat, 1,
                            idx[..., None].expand(-1, -1, feat.shape[-1]))

    return take(feat_1, id_1), take(feat_2, id_2)


def encode_image_dense(model: nn.Module, image: torch.Tensor) -> torch.Tensor:
    """``model.visual``'s dense tokens through its ``image_mapping`` (FILIP
    and DeFILIP alike), from the tower in eval mode (a ResNet's running
    BatchNorm statistics), as JAX's ``train=False``; the tower goes back to
    the mode it was in."""
    tower = model.visual
    was_training = tower.training
    tower.eval()
    try:
        _, tokens = tower(image, return_dense=True)
    finally:
        tower.train(was_training)
    return dense(tokens, model.image_mapping.weight, model.image_mapping.bias,
                 model.dtype)


def encode_text_dense(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    _, words = model.encode_text(tokens, return_dense=True)
    return dense(words, model.text_mapping.weight, model.text_mapping.bias,
                 model.dtype)


class FILIP(nn.Module):
    """``dense_mapping_image`` / ``dense_mapping_language`` are the JAX
    package's fields, unused there too (its Dense infers the input width);
    the heads here take the towers' widths."""

    def __init__(self, visual: nn.Module, text: nn.Module,
                 use_allgather: bool = True, return_dense: bool = True,
                 text_mask_type=None, dense_mapping_image: int = 768,
                 dense_mapping_language: int = 512,
                 dense_embed_dim: int = 256, select_topk: bool = False,
                 top_k: int = 16, mlm_max_positions: int = 24,
                 logit_bias_init: Optional[float] = None,
                 logit_scale_init: Optional[float] = None, dtype=None,
                 device=None, **compat):
        super().__init__()
        unknown = sorted(set(compat) - set(_COMPAT_KWARGS))
        if unknown:
            raise TypeError(f"FILIP got unexpected kwargs {unknown}")
        self.visual = visual
        self.encode_text = text
        self.use_allgather = use_allgather
        self.return_dense = return_dense
        self.text_mask_type = text_mask_type
        self.select_topk = select_topk
        self.top_k = top_k
        self.mlm_max_positions = mlm_max_positions
        self.dtype = as_dtype(dtype)
        self.logit_scale_init = (LOGIT_SCALE_INIT if logit_scale_init is None
                                 else logit_scale_init)
        self.logit_scale = nn.Parameter(torch.empty(1, device=device))
        # the SigLIP bias of the sigmoid loss kinds (logit_bias_init)
        self.logit_bias_init = logit_bias_init
        self.logit_bias = (nn.Parameter(torch.empty(1, device=device))
                           if logit_bias_init is not None else None)
        text_width = text.width
        if return_dense:
            self.logit_scale_dense = nn.Parameter(torch.empty((),
                                                              device=device))
            self.image_mapping = linear(visual.dense_width, dense_embed_dim,
                                        device)
            self.text_mapping = linear(text_width, dense_embed_dim, device)
        if text_mask_type is not None:
            self.text_label_predictor = linear(text_width, text.vocab_size,
                                               device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.visual.init_weights(generator)
        self.encode_text.init_weights(generator)
        nn.init.constant_(self.logit_scale, self.logit_scale_init)
        if self.logit_bias is not None:
            nn.init.constant_(self.logit_bias, self.logit_bias_init)
        heads = []
        if self.return_dense:
            nn.init.constant_(self.logit_scale_dense, LOGIT_SCALE_INIT)
            heads += [self.image_mapping, self.text_mapping]
        if self.text_mask_type is not None:
            heads.append(self.text_label_predictor)
        for layer in heads:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def scale_value(self) -> torch.Tensor:
        """exp(s) clamped to <=100 (clip.py:134)."""
        return torch.clamp(torch.exp(self.logit_scale[0]), max=LOGIT_SCALE_MAX)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer.weight, layer.bias, self.dtype)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def encode_image_dense(self, image: torch.Tensor) -> torch.Tensor:
        """The image tower's dense tokens through ``image_mapping``, not
        normalized, for the zero-shot late interaction (filip.py:63-66),
        from the tower in eval mode."""
        return encode_image_dense(self, image)

    def encode_text_dense(self, tokens: torch.Tensor) -> torch.Tensor:
        """The text tower's token features through ``text_mapping``, not
        normalized (filip.py:57-61)."""
        return encode_text_dense(self, tokens)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        if images.shape[-1] > 3:  # two-view input: view 1 (filip.py:111-112)
            images = images[..., :3]
        mlm = self.text_mask_type is not None
        out: Dict[str, torch.Tensor] = {}
        text_tokens = batch["mlm_tokens"] if mlm else batch["tokens"]
        text_embed, words = self.encode_text(text_tokens, return_dense=True)
        if mlm:
            labels = batch["mlm_labels"]
            words_mlm = words
            if self.mlm_max_positions and \
                    self.mlm_max_positions < words.shape[1]:
                words_mlm, labels = compact_mlm(words, labels,
                                                self.mlm_max_positions)
            out["mlm_logits"] = self._dense(self.text_label_predictor,
                                            words_mlm)
            out["mlm_labels"] = labels

        image_embed, image_dense = self.visual(images, return_dense=True)
        out["image_embed"] = l2_normalize(image_embed)
        out["text_embed"] = l2_normalize(text_embed, eps=1e-10)
        out["logit_scale"] = self.scale_value()
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias[0]

        if self.return_dense:
            dense_img = l2_normalize(self._dense(self.image_mapping,
                                                 image_dense))
            dense_txt = l2_normalize(self._dense(self.text_mapping, words))
            out["dense_image"] = dense_img
            out["dense_text"] = dense_txt
            if self.select_topk:
                # the query side keeps all its tokens; only the gathered
                # (key) side is top-k selected (filip.py:78-105)
                sel_img, sel_txt = topk_token_select(dense_img, dense_txt,
                                                     self.top_k)
            else:
                sel_img, sel_txt = dense_img, dense_txt
            out["dense_image_sel"] = sel_img
            out["dense_text_sel"] = sel_txt
            out["logit_scale_dense"] = torch.exp(self.logit_scale_dense)
        return out


def _filip(kwargs: dict, image_factory, device) -> FILIP:
    visual, text, ck = build_towers(kwargs, image_factory, device)
    ck["dtype"] = kwargs.get("dtype")
    return FILIP(visual, text, **ck)


@MODELS.register
def filip_res50(device=None, **kwargs) -> FILIP:
    return _filip(kwargs, modified_resnet_R50, device)


@MODELS.register
def filip_vitb32(device=None, **kwargs) -> FILIP:
    return _filip(kwargs, visual_transformer_B32, device)


@MODELS.register
def filip_vitl14(device=None, **kwargs) -> FILIP:
    return _filip(_l14_defaults(kwargs), visual_transformer_L14, device)
