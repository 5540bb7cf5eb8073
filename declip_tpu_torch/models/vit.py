"""CLIP-style Vision Transformer (port of declip_tpu/models/vit.py).

Non-overlapping patchify, class token + learned positional embedding,
pre/post LayerNorm, linear projection to the joint embedding space
(prototype/model/image_encoder/visual_transformer.py). Images are NHWC at
the public function, as the serving host sends them.

``freeze_conv1`` (hardcoded True in the reference, visual_transformer.py:12)
works as in the JAX package: ``frozen_param_paths()`` names the patch embed,
and the optimizer gives it a zero update. Its gradient is still computed, so
it counts in the global gradient norm as it does there.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from declip_tpu_torch.models.layers import (
    LayerNorm,
    Transformer,
    as_dtype,
    lecun_normal_,
)
from declip_tpu_torch.ops import quant


class PatchEmbed(nn.Module):
    """The reference's ``conv1`` (``weight`` [W, 3, p, p], no bias), run as a
    space-to-depth reshape plus one matmul, as the JAX package does it
    (vit.py:74-84). Identical to the strided conv for kernel == stride, and
    a plain matmul in the compute dtype (fp32 stays fp32, where a cuDNN
    ``Conv2d`` would run in TF32 by default on Hopper). It is an
    ``nn.Dense`` in the JAX package, so ``ops.quant.int8_inference`` routes
    it through int8 too."""

    def __init__(self, width: int, patch_size: int, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(width, 3, patch_size, patch_size, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, gh*gw, width], in x's dtype (the weight is
        cast to it)."""
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * 3)
        if quant.routes(x, self.weight.shape[0]):
            return quant.int8_dense(x, self.weight, None, x.dtype,
                                    matrix=self._kernel_t)
        kernel = self.weight.permute(2, 3, 1, 0).reshape(p * p * 3, -1)
        return x @ kernel.to(x.dtype)

    def _kernel_t(self, weight: torch.Tensor) -> torch.Tensor:
        """The conv-layout weight as the Dense's ``[width, p*p*3]``
        matrix, rows of (py, px, channel) as the patches are flattened."""
        return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def resize_pos_grid(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Bilinear resize of a [g0, g0, W] positional grid to [gh, gw, W].

    Matches ``jax.image.resize(..., method="bilinear")``: half-pixel
    centres (``align_corners=False``) and a triangle kernel widened by the
    scale when downsampling (``antialias=True``)."""
    x = grid.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(gh, gw), mode="bilinear", align_corners=False,
                      antialias=True)
    return x[0].permute(1, 2, 0)


class VisualTransformer(nn.Module):
    """``scan_unroll`` is the JAX package's ``lax.scan`` unroll over depth,
    an XLA scheduling knob: accepted so that its configs build, unused.
    ``moe_*`` (vit.py:44-49 of the JAX package): every block's MLP a
    :class:`~declip_tpu_torch.models.layers.MoeMlpBlock` of
    ``moe_experts`` experts (0: dense)."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 embed_dim: int = 512, checkpoint: bool = False,
                 remat_policy: str = "policy", scan_unroll: int = -1,
                 freeze_conv1: bool = True, dtype=None,
                 attn_impl: str = "auto", device=None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01):
        super().__init__()
        self.input_resolution = input_resolution
        self.patch_size = patch_size
        self.width = width
        self.dense_width = width
        self.embed_dim = embed_dim
        self.freeze_conv1 = freeze_conv1
        self.dtype = dtype = as_dtype(dtype)
        self.moe_experts = moe_experts
        g0 = input_resolution // patch_size  # grid the pos-emb was trained at
        self.conv1 = PatchEmbed(width, patch_size, device)
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(g0 * g0 + 1, width, device=device))
        self.ln_pre = LayerNorm(width, dtype=dtype, device=device)
        self.transformer = Transformer(
            width, layers, heads, attn_impl=attn_impl, dtype=dtype,
            checkpoint=checkpoint, remat_policy=remat_policy, device=device,
            moe_experts=moe_experts, moe_top_k=moe_top_k,
            moe_capacity_factor=moe_capacity_factor,
            moe_aux_weight=moe_aux_weight)
        self.ln_post = LayerNorm(width, dtype=dtype, device=device)
        self.proj = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init stds (vit.py:78-93, 127-129)."""
        scale = self.width ** -0.5
        self.conv1.init_weights(generator)
        nn.init.normal_(self.class_embedding, std=scale, generator=generator)
        nn.init.normal_(self.positional_embedding, std=0.01,
                        generator=generator)
        self.ln_pre.reset_parameters()
        self.transformer.init_weights(generator)
        self.ln_post.reset_parameters()
        nn.init.normal_(self.proj, std=scale, generator=generator)

    def forward(self, x: torch.Tensor, return_dense: bool = False,
                return_feature: bool = False):
        """x: [B, H, W, 3] (NHWC) -> [B, embed_dim]; with ``return_dense``
        also the patch tokens [B, gh*gw, width], taken before ``ln_post``,
        with ``return_feature`` the class token after ``ln_post`` and before
        ``proj`` [B, width] (vit.py:125-137), as a tuple in that order."""
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(
                f"input {h}x{w} is not a multiple of patch_size={p}")
        gh, gw = h // p, w // p
        g0 = self.input_resolution // p
        x = self.conv1(x.to(self.dtype))  # compute dtype from here on
        pos = self.positional_embedding
        if (gh, gw) != (g0, g0):
            # off-resolution input: bilinearly resize the patch grid of the
            # positional embedding (vit.py:94-103); a no-op at (g0, g0)
            grid = resize_pos_grid(pos[1:].reshape(g0, g0, self.width), gh, gw)
            pos = torch.cat([pos[:1], grid.reshape(gh * gw, self.width)])
        cls = self.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + pos.to(x.dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        feature = self.ln_post(x[:, 0, :])
        out = feature @ self.proj.to(feature.dtype)
        ret = [out]
        if return_dense:
            ret.append(x[:, 1:, :])
        if return_feature:
            ret.append(feature)
        return ret[0] if len(ret) == 1 else tuple(ret)

    def frozen_param_paths(self) -> Tuple[str, ...]:
        """Parameter subtrees the optimizer must not update (freeze_conv1)."""
        return ("conv1",) if self.freeze_conv1 else ()


def visual_transformer_B32(**kwargs) -> VisualTransformer:
    defaults = dict(
        input_resolution=224, patch_size=32, width=768, layers=12, heads=12
    )
    defaults.update(kwargs)
    return VisualTransformer(**defaults)


def visual_transformer_B16(**kwargs) -> VisualTransformer:
    defaults = dict(
        input_resolution=224, patch_size=16, width=768, layers=12, heads=12
    )
    defaults.update(kwargs)
    return VisualTransformer(**defaults)


def visual_transformer_L14(**kwargs) -> VisualTransformer:
    """ViT-L/14 (OpenAI CLIP geometry: width 1024, 24 layers, 16 heads)."""
    defaults = dict(
        input_resolution=224, patch_size=14, width=1024, layers=24, heads=16
    )
    defaults.update(kwargs)
    return VisualTransformer(**defaults)
