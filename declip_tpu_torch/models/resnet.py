"""CLIP ModifiedResNet (port of declip_tpu/models/resnet.py).

Rebuilds prototype/model/image_encoder/modified_resnet.py as the JAX package
does: a 3-conv stem with avgpool, Bottleneck blocks that avg-pool before
their stride (every conv is stride 1 there), and an attention-pooling head
that computes only the pooled (mean) query.

Layout. The batch arrives NHWC, as in the port's ViT. ``permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is an NCHW view in ``channels_last`` memory, the
layout cuDNN's tensor-core convolutions take, so no copy to NCHW is made.
Convs, BatchNorm (``layers.BatchNorm``, flax's semantics) and the dense
layers are library calls (cuDNN, cuBLAS), as XLA did them in the JAX
package.

Precision follows flax's ``dtype``: parameters stay fp32 and are cast to the
compute dtype at use. On a card an fp32 conv runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False (PyTorch's default is True):
the port leaves that switch to the caller. The recipes train in bf16, where it
does not apply; the fp32 checks of ``chip_smoke.py`` turn it off.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from declip_tpu_torch.models.layers import (
    BatchNorm,
    as_dtype,
    dense,
    init_linear,
    lecun_normal_,
    linear,
)
from declip_tpu_torch.models.vit import resize_pos_grid
from declip_tpu_torch.ops.attention import (
    dot_product_attention,
    merge_heads,
    split_heads,
)

class Conv2d(nn.Conv2d):
    """A bias-free conv in the compute ``dtype`` (flax ``nn.Conv(dtype=)``:
    input and kernel cast to it), on channels_last tensors."""

    def __init__(self, d_in: int, d_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, device=None):
        super().__init__(d_in, d_out, kernel, stride=stride, padding=padding,
                         bias=False, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.compute_dtype,
                           memory_format=torch.channels_last)
        return F.conv2d(x.to(self.compute_dtype), w, None, self.stride,
                        self.padding)


def _conv(d_in: int, d_out: int, kernel: int, dtype, device) -> Conv2d:
    """flax ``SAME`` padding for 3x3 (stride 1), ``VALID`` for 1x1."""
    return Conv2d(d_in, d_out, kernel, padding=kernel // 2, dtype=dtype,
                  device=device)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avgpool if stride > 1) -> 1x1, all convs stride 1
    (modified_resnet.py:14-57); ``bn3`` starts at zero scale. The shortcut,
    where it changes shape, is avgpool then ``downsample.0`` (conv) and
    ``downsample.1`` (BN), the reference's names."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=torch.float32, bn_stats_groups: int = 1, device=None,
                 bn_axis_name=None):
        super().__init__()
        self.stride = stride
        out_planes = planes * self.expansion

        def bn(c, zero_scale=False):
            return BatchNorm(c, zero_scale, bn_stats_groups, device,
                             bn_axis_name)

        self.conv1 = _conv(inplanes, planes, 1, dtype, device)
        self.bn1 = bn(planes)
        self.conv2 = _conv(planes, planes, 3, dtype, device)
        self.bn2 = bn(planes)
        self.conv3 = _conv(planes, out_planes, 1, dtype, device)
        self.bn3 = bn(out_planes, zero_scale=True)
        self.downsample = None
        if stride > 1 or inplanes != out_planes:
            self.downsample = nn.Sequential(
                _conv(inplanes, out_planes, 1, dtype, device),
                bn(out_planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV pooling over the spatial positions plus their mean token
    (modified_resnet.py:60-96), for the pooled query only: the mean token
    against all HW + 1 tokens. The positional embedding is parameterised
    at ``trained_grid`` and bilinearly resized (antialiased, as
    ``jax.image.resize``) for other grids."""

    def __init__(self, width: int, num_heads: int, output_dim: int,
                 trained_grid: int, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.trained_grid = trained_grid
        self.dtype = dtype
        self.positional_embedding = nn.Parameter(
            torch.empty(trained_grid ** 2 + 1, width, device=device))
        self.q_proj = linear(width, width, device)
        self.k_proj = linear(width, width, device)
        self.v_proj = linear(width, width, device)
        self.c_proj = linear(width, output_dim, device)

    def init_weights(self, generator: torch.Generator) -> None:
        std = self.positional_embedding.shape[1] ** -0.5
        nn.init.normal_(self.positional_embedding, std=std,
                        generator=generator)
        for layer in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            init_linear(layer, std, generator)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer.weight, layer.bias, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] -> [B, output_dim]."""
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        pos = self.positional_embedding
        g0 = self.trained_grid
        if (h, w) != (g0, g0):
            grid = resize_pos_grid(pos[1:].reshape(g0, g0, c), h, w)
            pos = torch.cat([pos[:1].float(), grid.reshape(h * w, c)])
        tokens = tokens + pos.to(tokens.dtype)
        q = split_heads(self._dense(self.q_proj, tokens[:, :1]),
                        self.num_heads)
        k = split_heads(self._dense(self.k_proj, tokens), self.num_heads)
        v = split_heads(self._dense(self.v_proj, tokens), self.num_heads)
        o = merge_heads(dot_product_attention(q, k, v))[:, 0]
        return self._dense(self.c_proj, o)


class ModifiedResNet(nn.Module):
    """The JAX package's ``ModifiedResNet`` fields. ``use_sync_bn``,
    ``bn_group_size`` and ``bn_sync_stats`` are the reference's keys, which
    ``models.bind_data_group`` resolves over a data-parallel world into
    ``bn_axis_name`` (a ``layers.BnAxis``: the rank group whose moments
    each BatchNorm takes); on one process BatchNorm takes the moments of the
    whole batch, which is what they resolve to there (``bn_stats_groups``
    sets groups within one batch). ``fc_embed`` (modified_resnet_modified.py): attnpool emits
    the raw width*32 feature and ``fc`` projects it. Off the trained grid
    (input_resolution // 32), the head is the spatial mean and ``fc``
    (modified_resnet.py:205-210), which needs ``fc_embed``, unless
    ``attnpool_all_res`` sends every grid through attnpool."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 embed_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224, width: int = 64, dtype=None,
                 bn_axis_name=None, bn_group_size: int = 1,
                 bn_sync_stats: bool = False, use_sync_bn: bool = True,
                 bn_stats_groups: int = 1, bn_stats_dtype=None,
                 fc_embed: bool = False, attnpool_all_res: bool = False,
                 device=None):
        super().__init__()
        if as_dtype(bn_stats_dtype) != torch.float32:
            raise NotImplementedError(
                "bn_stats_dtype other than float32 (the JAX bench's "
                "--bn-bf16-stats experiment) is not ported")
        self.layers = tuple(layers)
        self.embed_dim = embed_dim
        self.heads = heads
        self.input_resolution = input_resolution
        self.width = width
        self.dense_width = width * 32
        self.fc_embed = fc_embed
        self.attnpool_all_res = attnpool_all_res
        self.dtype = dtype = as_dtype(dtype)

        def bn(c):
            return BatchNorm(c, stats_groups=bn_stats_groups, device=device,
                             axis_name=bn_axis_name)

        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1,
                            dtype=dtype, device=device)
        self.bn1 = bn(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3, dtype, device)
        self.bn2 = bn(width // 2)
        self.conv3 = _conv(width // 2, width, 3, dtype, device)
        self.bn3 = bn(width)
        inplanes = width
        for stage, (blocks, stride) in enumerate(zip(self.layers,
                                                     (1, 2, 2, 2))):
            planes = width * 2 ** stage
            stack = []
            for i in range(blocks):
                stack.append(Bottleneck(inplanes, planes,
                                        stride if i == 0 else 1, dtype,
                                        bn_stats_groups, device,
                                        bn_axis_name))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(stack))
        pool_dim = self.dense_width if fc_embed else embed_dim
        self.attnpool = AttentionPool2d(self.dense_width, heads, pool_dim,
                                        input_resolution // 32, dtype, device)
        self.fc = (linear(self.dense_width, embed_dim, device) if fc_embed
                   else None)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's inits: lecun-normal conv kernels and ``fc``, BN scale 1
        (0 for each block's ``bn3``) and bias 0, attnpool as there."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, BatchNorm):
                m.init_weights()
        self.attnpool.init_weights(generator)
        if self.fc is not None:
            lecun_normal_(self.fc.weight, generator)
            nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, return_dense: bool = False,
                return_feature: bool = False):
        """x: [B, H, W, 3] (NHWC) -> [B, embed_dim]; with ``return_dense``
        also the last stage's tokens [B, HW, width*32], with
        ``return_feature`` the pooled feature before ``fc`` (the pooled
        output itself without ``fc_embed``), as a tuple in that order."""
        x = x.to(self.dtype).contiguous().permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(len(self.layers)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x)

        b, c, h, w = x.shape
        dense_tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if h == self.input_resolution // 32 or self.attnpool_all_res:
            feature = self.attnpool(x)
            pooled = feature if self.fc is None else self._fc(feature)
        else:
            if self.fc is None:
                raise ValueError(
                    f"a {h}x{w} grid takes the mean+fc head, and this tower "
                    f"has no fc (fc_embed is off; attnpool_all_res sends "
                    f"every grid through attnpool)")
            feature = x.float().mean(dim=(2, 3)).to(x.dtype)
            pooled = self._fc(feature)
        ret = [pooled]
        if return_dense:
            ret.append(dense_tokens)
        if return_feature:
            ret.append(feature)
        return ret[0] if len(ret) == 1 else tuple(ret)

    def _fc(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.fc.weight, self.fc.bias, self.dtype)

    def frozen_param_paths(self) -> Tuple[str, ...]:
        return ()


def modified_resnet_R50(**kwargs) -> ModifiedResNet:
    defaults = dict(layers=(3, 4, 6, 3), heads=32, input_resolution=224,
                    width=64)
    defaults.update(kwargs)
    return ModifiedResNet(**defaults)


def modified_resnet_R101(**kwargs) -> ModifiedResNet:
    defaults = dict(layers=(3, 4, 23, 3), heads=32, input_resolution=224,
                    width=64)
    defaults.update(kwargs)
    return ModifiedResNet(**defaults)
