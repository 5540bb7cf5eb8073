"""SLIP: CLIP plus a SimCLR image branch (port of
declip_tpu/models/slip_model.py).

Rebuilds prototype/model/slip.py as the JAX package does: three views split
from the channel axis, base then two strong views (``[B, H, W, 9]``,
slip.py:248); CLIP on the base view; ``predictor_sim``, a projection MLP
(hidden 4096 -> ``sim_dim``, no output BatchNorm, slip.py:215) on each strong
view's image feature, called twice a step so that its BatchNorm statistics
move twice, in that order. The SimCLR NT-Xent over them is the loss's
(``train/method_losses.py``).

The sim feature is a ViT's class token before its projection
(``return_feature``, the tower's width) and a ResNet's pooled embedding
(the attention pool's output, which has no separate pre-projection
feature).
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
    l2_normalize,
)
from declip_tpu_torch.models.heads import ProjectionMLP
from declip_tpu_torch.models.layers import as_dtype
from declip_tpu_torch.models.resnet import ModifiedResNet, modified_resnet_R50
from declip_tpu_torch.models.vit import (
    visual_transformer_B32,
    visual_transformer_L14,
)
from declip_tpu_torch.utils.registry import MODELS


class SLIP(nn.Module):
    """The JAX package's fields. ``use_allgather``, ``feature_dim`` and
    ``forward_type`` are accepted and unused, as there; ``EDA`` is read by
    no loader for SLIP (the solver makes EDA captions for DeCLIP and DeFILIP
    only, as the JAX one does)."""

    def __init__(self, visual: nn.Module, text: nn.Module,
                 use_allgather: bool = True, EDA: bool = True,
                 feature_dim: int = 1024, sim_dim: int = 256,
                 forward_type: str = "split", return_sim: bool = True,
                 logit_bias_init: Optional[float] = None,
                 logit_scale_init: Optional[float] = None, dtype=None,
                 device=None):
        super().__init__()
        self.visual = visual
        self.encode_text = text
        self.use_allgather = use_allgather
        self.EDA = EDA
        self.feature_dim = feature_dim
        self.return_sim = return_sim
        self.dtype = dtype = as_dtype(dtype)
        self.logit_scale_init = (LOGIT_SCALE_INIT if logit_scale_init is None
                                 else logit_scale_init)
        self.logit_scale = nn.Parameter(torch.empty(1, device=device))
        # the SigLIP bias of the sigmoid loss kinds (logit_bias_init)
        self.logit_bias_init = logit_bias_init
        self.logit_bias = (nn.Parameter(torch.empty(1, device=device))
                           if logit_bias_init is not None else None)
        if return_sim:
            in_dim = (visual.embed_dim if isinstance(visual, ModifiedResNet)
                      else visual.width)
            self.predictor_sim = ProjectionMLP(
                in_dim, hidden_dim=4096, out_dim=sim_dim, out_bn=False,
                dtype=dtype, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.visual.init_weights(generator)
        self.encode_text.init_weights(generator)
        nn.init.constant_(self.logit_scale, self.logit_scale_init)
        if self.logit_bias is not None:
            nn.init.constant_(self.logit_bias, self.logit_bias_init)
        if self.return_sim:
            self.predictor_sim.init_weights(generator)

    def scale_value(self) -> torch.Tensor:
        """exp(s) clamped to <=100 (clip.py:134)."""
        return torch.clamp(torch.exp(self.logit_scale[0]), max=LOGIT_SCALE_MAX)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        return self.visual(image)

    def _sim_feature(self, image: torch.Tensor) -> torch.Tensor:
        if isinstance(self.visual, ModifiedResNet):
            return self.visual(image)
        return self.visual(image, return_feature=True)[1]

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        images = batch["images"]  # [B, H, W, 9]: base + two strong views
        img_base, img_1, img_2 = (images[..., :3], images[..., 3:6],
                                  images[..., 6:9])
        text_embed = self.encode_text(batch["tokens"])
        image_embed = self.visual(img_base)
        out: Dict[str, Any] = {
            "image_embed": l2_normalize(image_embed),
            "text_embed": l2_normalize(text_embed, eps=1e-10),
            "logit_scale": self.scale_value(),
        }
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias[0]
        if self.return_sim:
            feat_1 = self._sim_feature(img_1)
            feat_2 = self._sim_feature(img_2)
            out["image_sim_1"] = self.predictor_sim(feat_1)
            out["image_sim_2"] = self.predictor_sim(feat_2)
        return out


def _slip(kwargs: dict, image_factory, device) -> SLIP:
    visual, text, ck = build_towers(kwargs, image_factory, device)
    ck["dtype"] = kwargs.get("dtype")
    return SLIP(visual, text, **ck)


@MODELS.register
def slip_res50(device=None, **kwargs) -> SLIP:
    return _slip(kwargs, modified_resnet_R50, device)


@MODELS.register
def slip_vitb32(device=None, **kwargs) -> SLIP:
    return _slip(kwargs, visual_transformer_B32, device)


@MODELS.register
def slip_vitl14(device=None, **kwargs) -> SLIP:
    return _slip(_l14_defaults(kwargs), visual_transformer_L14, device)
