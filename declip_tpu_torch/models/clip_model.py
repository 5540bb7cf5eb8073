"""CLIP dual-encoder (port of declip_tpu/models/clip_model.py).

Submodules carry the reference's names: ``visual`` and ``encode_text`` (the
text tower is itself the ``encode_text`` callable, as in the reference's
torch model), plus the ``logit_scale`` parameter. The forward returns local
normalized features and the clamped logit scale, like the JAX model. The
features come out in the towers' compute dtype and are normalized in it, as
in JAX; the logit scale is fp32.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
from torch import nn

from declip_tpu_torch.models.layers import (
    BatchNorm,
    BnAxis,
    MoeMlpBlock,
    as_dtype,
)
from declip_tpu_torch.models.resnet import (
    modified_resnet_R50,
    modified_resnet_R101,
)
from declip_tpu_torch.models.text import text_transformers
from declip_tpu_torch.models.vit import (
    visual_transformer_B16,
    visual_transformer_B32,
    visual_transformer_L14,
)
from declip_tpu_torch.utils.registry import MODELS

LOGIT_SCALE_INIT = math.log(1 / 0.07)
LOGIT_SCALE_MAX = 100.0


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Reference normalizes image features with no eps, text with +1e-10
    (clip.py:128-130)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def compact_mlm(words: torch.Tensor, labels: torch.Tensor,
                max_positions: int):
    """Gather (up to) ``max_positions`` masked token positions ahead of the
    vocab-sized MLM projection (clip_model.py:46-66 of the JAX package).

    A stable sort puts each row's masked positions first, in sequence
    order; truncating to the cap keeps the CE identical whenever a row has
    at most ``max_positions`` masked tokens, and positions past the cap are
    dropped, as in JAX. words [B, L, W], labels [B, L] -> [B, cap, W],
    [B, cap]."""
    unmasked = (labels == -100).int()
    order = torch.argsort(unmasked, dim=1, stable=True)[:, :max_positions]
    words = torch.gather(
        words, 1, order[..., None].expand(-1, -1, words.shape[-1]))
    return words, torch.gather(labels, 1, order)


class CLIP(nn.Module):
    def __init__(self, visual: nn.Module, text: nn.Module,
                 use_allgather: bool = True,
                 logit_bias_init: Optional[float] = None,
                 logit_scale_init: Optional[float] = None, device=None):
        super().__init__()
        self.visual = visual
        self.encode_text = text
        # accepted for config compatibility: global logits are the loss
        # layer's business (training slice)
        self.use_allgather = use_allgather
        self.logit_scale_init = (LOGIT_SCALE_INIT if logit_scale_init is None
                                 else logit_scale_init)
        self.logit_bias_init = logit_bias_init
        self.logit_scale = nn.Parameter(torch.empty(1, device=device))
        self.logit_bias = (nn.Parameter(torch.empty(1, device=device))
                           if logit_bias_init is not None else None)

    def init_weights(self, generator: torch.Generator) -> None:
        self.visual.init_weights(generator)
        self.encode_text.init_weights(generator)
        nn.init.constant_(self.logit_scale, self.logit_scale_init)
        if self.logit_bias is not None:
            nn.init.constant_(self.logit_bias, self.logit_bias_init)

    def scale_value(self) -> torch.Tensor:
        """exp(s) clamped to <=100 (clip.py:134)."""
        return torch.clamp(torch.exp(self.logit_scale[0]), max=LOGIT_SCALE_MAX)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        if images.shape[-1] > 3:  # multi-view input: CLIP uses view 1 only
            images = images[..., :3]
        out = {
            "image_embed": l2_normalize(self.encode_image(images)),
            "text_embed": l2_normalize(self.encode_text(batch["tokens"]),
                                       eps=1e-10),
            "logit_scale": self.scale_value(),
        }
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias[0]
        return out


def resolve_bn_stats_groups(bn_world: int, *, use_sync_bn: bool = True,
                            bn_group_size: int = 1) -> int:
    """The reference's BatchNorm keys as a number of contiguous rank groups
    (modified_resnet.py:116-142; the JAX package's function of this name):
    ``use_sync_bn: False`` is per-rank moments (``bn_world`` groups,
    ``bn_group_size`` ignored); ``bn_group_size: G`` with a world larger
    than G is world/G groups of G ranks; anything else is 1, the global
    moments (with a warning where G does not divide the world)."""
    if use_sync_bn is False:
        return max(1, bn_world)
    if bn_group_size > 1 and bn_world > bn_group_size:
        if bn_world % bn_group_size:
            import logging

            logging.getLogger("declip_tpu_torch").warning(
                "bn_group_size=%d does not divide the data-parallel world "
                "%d (the reference's simple_group_split would reject this "
                "too): BatchNorm takes the global moments.", bn_group_size,
                bn_world)
            return 1
        return bn_world // bn_group_size
    return 1


def bind_data_group(model: nn.Module, group, *, use_sync_bn: bool = True,
                    bn_group_size: int = 1) -> nn.Module:
    """Every BatchNorm of ``model`` across the ranks of the data group
    ``group`` (``parallel.Group``). The image tower's take the moments of
    their rank group, ``resolve_bn_stats_groups`` of the tower's
    ``use_sync_bn``/``bn_group_size`` over the world as contiguous groups
    (``comms.group_split``); the heads' (SimSiam, SLIP's predictor) take
    the global moments, as they do on the JAX solver's global batch. The
    running statistics take the global moments everywhere. Every rank
    makes every subgroup, in the same order (torch's rule). MoE blocks
    route over the group's global batch (``MoeMlpBlock.group``). An SSL
    model's
    key encoder (``ssl_builders.init_moco_state``, a copy of the model made
    after this binding) shares its BatchNorms' groups."""
    from declip_tpu_torch.parallel import comms
    from declip_tpu_torch.parallel.dist import new_group

    groups = resolve_bn_stats_groups(group.size, use_sync_bn=use_sync_bn,
                                     bn_group_size=bn_group_size)
    if groups == 1:
        norm = group
    elif groups == group.size:
        norm = None  # per-rank moments
    else:
        mine = None
        for ranks in comms.group_split(group.size, group.size // groups):
            sub = new_group([group.ranks[r] for r in ranks])
            if group.rank in ranks:
                mine = sub
        norm = mine
    tower, heads = BnAxis(norm, group), BnAxis(group, group)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.axis_name = tower if name.startswith("visual.") else heads
        elif isinstance(m, MoeMlpBlock):
            m.group = group  # MoE routes over the global batch
    return model


def expand_moe(tower: dict) -> dict:
    """A tower's ``moe: {num_experts, top_k, capacity_factor, aux_weight}``
    as its ``moe_*`` kwargs, in place (clip_model.py:171-179 of the JAX
    package). Transformer towers take them; a ResNet tower refuses them
    (an unknown kwarg), as in the JAX package."""
    moe = tower.pop("moe", None)
    if moe:
        tower["moe_experts"] = int(moe.get("num_experts", 0))
        for src, dst in (("top_k", "moe_top_k"),
                         ("capacity_factor", "moe_capacity_factor"),
                         ("aux_weight", "moe_aux_weight")):
            if src in moe:
                tower[dst] = moe[src]
    return tower


def build_towers(kwargs: dict, image_factory, device=None):
    """Shared factory plumbing (clip.py:149-165): ``image_encode``,
    ``text_encode`` and the method kwargs under ``clip``. The model-level
    ``dtype`` (the solver puts ``precision.dtype`` there) is each tower's
    compute dtype unless the tower sets its own. A ResNet tower's
    ``use_sync_bn``/``bn_group_size`` pass through as the reference's keys:
    on one process they resolve to the global batch (``bn_stats_groups``
    1); over a data-parallel world ``model_entry(..., data_group=)`` maps
    them onto rank groups (``bind_data_group``)."""
    from declip_tpu_torch.tokenizer import get_tokenizer

    dtype = as_dtype(kwargs.get("dtype"))
    image_kwargs = dict(kwargs.get("image_encode") or {})
    text_kwargs = dict(kwargs.get("text_encode") or {})
    for tower in (image_kwargs, text_kwargs):
        expand_moe(tower)
    image_kwargs.setdefault("dtype", dtype)
    text_kwargs.setdefault("dtype", dtype)
    encode_type = text_kwargs.get("text_encode_type") or "Transformer"
    if "vocab_size" not in text_kwargs and encode_type == "Transformer":
        bpe_path = text_kwargs.get("bpe_path")
        if bpe_path is not None and not os.path.exists(bpe_path):
            bpe_path = None  # reference configs carry cluster-relative paths
        text_kwargs["bpe_path"] = bpe_path
        text_kwargs["vocab_size"] = get_tokenizer(bpe_path).vocab_size
    visual = image_factory(device=device, **image_kwargs)
    text = text_transformers(device=device, **text_kwargs)
    clip_kwargs = dict(kwargs.get("clip") or {})
    clip_kwargs["device"] = device
    return visual, text, clip_kwargs


@MODELS.register
def clip_res50(device=None, **kwargs) -> CLIP:
    visual, text, ck = build_towers(kwargs, modified_resnet_R50, device)
    return CLIP(visual, text, **ck)


@MODELS.register
def clip_res101(device=None, **kwargs) -> CLIP:
    visual, text, ck = build_towers(kwargs, modified_resnet_R101, device)
    return CLIP(visual, text, **ck)


@MODELS.register
def clip_vitb32(device=None, **kwargs) -> CLIP:
    visual, text, ck = build_towers(kwargs, visual_transformer_B32, device)
    return CLIP(visual, text, **ck)


@MODELS.register
def clip_vitb16(device=None, **kwargs) -> CLIP:
    visual, text, ck = build_towers(kwargs, visual_transformer_B16, device)
    return CLIP(visual, text, **ck)


def _l14_defaults(kwargs: dict) -> dict:
    """ViT-L/14 tower pairing (OpenAI CLIP geometry): 768-dim joint space,
    768-wide/12-head text tower."""
    kwargs = dict(kwargs)
    ie = dict(kwargs.get("image_encode") or {})
    ie.setdefault("embed_dim", 768)
    kwargs["image_encode"] = ie
    te = dict(kwargs.get("text_encode") or {})
    te.setdefault("embed_dim", 768)
    te.setdefault("transformer_width", 768)
    te.setdefault("transformer_heads", 12)
    kwargs["text_encode"] = te
    return kwargs


@MODELS.register
def clip_vitl14(device=None, **kwargs) -> CLIP:
    visual, text, ck = build_towers(_l14_defaults(kwargs),
                                    visual_transformer_L14, device)
    return CLIP(visual, text, **ck)


@MODELS.register
def clip_vitl14_336(device=None, **kwargs) -> CLIP:
    """OpenAI CLIP's high-res variant: 336px / 14px patches -> 577 image
    tokens, the longest sequence any tower here runs."""
    kwargs = _l14_defaults(kwargs)
    kwargs["image_encode"].setdefault("input_resolution", 336)
    visual, text, ck = build_towers(kwargs, visual_transformer_L14, device)
    return CLIP(visual, text, **ck)
