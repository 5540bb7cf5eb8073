"""The pure-vision SSL builders: MoCo, SimCLR and CLSA (port of
declip_tpu/models/ssl_builders.py).

Rebuilds prototype/utils/{moco,simclr,clsa}_builder.py as the JAX package
does: an encoder (a CLIP image tower) and a projection head, the method
dispatched by the train step (train/train_step.py), the loss math in
train/method_losses.py (``simclr_losses``, ``moco_losses``).

MoCo's momentum encoder and negatives queue are train-step state, a
:class:`MoCoState`: the key encoder is a copy of the model, its parameters
the key parameters and its BatchNorm buffers the key encoder's own running
statistics, which key forwards move and the momentum never mixes
(moco_builder.py's ``encoder_k`` buffers). The JAX package applies the same
module to ``key_params``; a frozen copy is the same function, and it keeps
its own BatchNorm pending state. ShuffleBN is left out as there: over a
data-parallel world both encoders' BatchNorms take the moments of the
global batch (``clip_model.bind_data_group``, whose rank groups the copy
shares), which removes the per-GPU leak ShuffleBN patches.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from declip_tpu_torch.models.heads import _Head
from declip_tpu_torch.models.layers import (
    BatchNorm,
    as_dtype,
    dense,
    discard_bn_stats,
    lecun_normal_,
    linear,
)
from declip_tpu_torch.models.memory_bank import BankState, enqueue
from declip_tpu_torch.models.resnet import (
    modified_resnet_R50,
    modified_resnet_R101,
)
from declip_tpu_torch.models.vit import (
    visual_transformer_B16,
    visual_transformer_B32,
)
from declip_tpu_torch.utils.registry import MODELS


@dataclass
class MoCoState:
    # the momentum encoder, a frozen copy of the model: its parameters are
    # the key parameters, its BatchNorm buffers the key statistics
    key_model: nn.Module
    queue: torch.Tensor  # [K, dim] normalized negatives, fp32
    queue_ptr: int  # next write position


def init_moco_state(model: nn.Module, generator: torch.Generator,
                    queue_size: int, dim: int) -> MoCoState:
    """The key encoder as a copy of ``model`` (its parameters and BatchNorm
    statistics, and the data group its BatchNorms are bound to), and a
    queue of random unit rows drawn on the CPU from ``generator`` and moved
    to the model's device (ssl_builders.py:38-45)."""
    shared = {id(m.axis_name): m.axis_name for m in model.modules()
              if isinstance(m, BatchNorm) and m.axis_name is not None}
    key = copy.deepcopy(model, shared)
    key.requires_grad_(False)
    key.train()
    discard_bn_stats(key)
    q = torch.randn(queue_size, dim, generator=generator, dtype=torch.float32)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return MoCoState(key, q.to(next(model.parameters()).device), 0)


@torch.no_grad()
def momentum_update(state: MoCoState, model: nn.Module,
                    m: float = 0.999) -> List[torch.Tensor]:
    """``key = m * key + (1 - m) * param`` for every parameter, in place
    (ssl_builders.py:48-52). Returns copies of the key parameters as they
    were, for ``restore_keys`` after a step that is not kept."""
    keys = list(state.key_model.parameters())
    old = [k.clone() for k in keys]
    torch._foreach_mul_(keys, m)
    torch._foreach_add_(keys, [p.detach() for p in model.parameters()],
                        alpha=1 - m)
    return old


@torch.no_grad()
def restore_keys(state: MoCoState, old: List[torch.Tensor]) -> None:
    torch._foreach_copy_(list(state.key_model.parameters()), old)


@torch.no_grad()
def encode_keys(state: MoCoState, batch: Dict[str, Any]) -> torch.Tensor:
    """The keys of view 2 (``images[..., 3:6]``) through the key encoder in
    training mode, no gradient (train_step.py:213-221 of the JAX package):
    its BatchNorms leave their statistics pending on the key encoder."""
    return state.key_model.encode(batch["images"][..., 3:6])


def enqueue_keys(state: MoCoState, keys: torch.Tensor) -> MoCoState:
    """Write a [k, dim] batch of keys at ``queue_ptr``, in place, as the JAX
    package does (ssl_builders.py:55-62), which is the NN bank's write
    (``memory_bank.enqueue``): the start is clamped to ``K - k`` so that
    the whole batch lands, and the pointer goes to 0 once ``ptr + k``
    reaches K. Not a ring: a batch that does not divide K overwrites the
    queue's tail."""
    state.queue_ptr = enqueue(BankState(state.queue, state.queue_ptr),
                              keys).ptr
    return state


class SimCLRHead(_Head):
    """2-layer projection head (simclr_builder.py): ``fc1``, ReLU,
    ``fc2``."""

    def __init__(self, in_dim: int, hidden_dim: int = 2048,
                 out_dim: int = 128, dtype=torch.float32, device=None):
        super().__init__(dtype)
        self.fc1 = linear(in_dim, hidden_dim, device)
        self.fc2 = linear(hidden_dim, out_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._dense(self.fc2, F.relu(self._dense(self.fc1, x)))


class SSLModel(nn.Module):
    """Encoder + projection head, the JAX package's fields. The head's
    parameter names follow its layout there: ``head.fc1``/``head.fc2``
    (SimCLR), ``head_fc1``/``head_fc2`` (MoCo-v2's mlp head,
    moco_builder.py:25-28), ``head_fc2`` alone without ``mlp``.

    The forward takes the batch (or its images, [B, H, W, 6], the two weak
    views on the channel axis) and returns the normalized fp32 queries of
    view 1 under ``q``; SimCLR adds view 2's under ``z2``, CLSA each strong
    view's (``images_strong_{i}``) under ``q_strong``. MoCo's keys are the
    train step's (``encode_keys``)."""

    def __init__(self, visual: nn.Module, ssl_method: str = "moco",
                 dim: int = 128, K: int = 65536, m: float = 0.999,
                 T: float = 0.07, mlp: bool = True, hidden_dim: int = 2048,
                 clsa_ratio: float = 1.0, clsa_avg: bool = True, dtype=None,
                 device=None):
        super().__init__()
        if ssl_method not in ("moco", "simclr", "clsa"):
            raise ValueError(f"ssl_method {ssl_method!r}: moco|simclr|clsa")
        self.visual = visual
        self.ssl_method = ssl_method
        self.dim, self.K, self.m, self.T = dim, K, m, T
        self.mlp = mlp
        self.hidden_dim = hidden_dim
        self.clsa_ratio, self.clsa_avg = clsa_ratio, clsa_avg
        self.dtype = dtype = as_dtype(dtype)
        in_dim = visual.embed_dim
        if ssl_method == "simclr":
            self.head = SimCLRHead(in_dim, hidden_dim, dim, dtype, device)
        else:
            if mlp:
                self.head_fc1 = linear(in_dim, hidden_dim, device)
            self.head_fc2 = linear(hidden_dim if mlp else in_dim, dim,
                                   device)

    def init_weights(self, generator: torch.Generator) -> None:
        """The tower's init, then flax's for the head (lecun-normal
        kernels, zero biases)."""
        self.visual.init_weights(generator)
        if self.ssl_method == "simclr":
            self.head.init_weights(generator)
            return
        for layer in (getattr(self, "head_fc1", None), self.head_fc2):
            if layer is not None:
                lecun_normal_(layer.weight, generator)
                nn.init.zeros_(layer.bias)

    def _head(self, feat: torch.Tensor) -> torch.Tensor:
        if self.ssl_method == "simclr":
            return self.head(feat)
        if self.mlp:
            feat = F.relu(dense(feat, self.head_fc1.weight,
                                self.head_fc1.bias, self.dtype))
        return dense(feat, self.head_fc2.weight, self.head_fc2.bias,
                     self.dtype)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> L2-normalized fp32 [B, dim]."""
        z = self._head(self.visual(images.to(self.dtype))).float()
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def forward(self, batch) -> Dict[str, Any]:
        images = batch["images"] if isinstance(batch, dict) else batch
        if images.shape[-1] < 6:
            # a single-view transform (e.g. STANDARD_CLIP) would leave the
            # second view empty
            raise ValueError(
                f"{self.ssl_method} needs a two-view transform (6-channel "
                f"images, e.g. MOCOV2); got {images.shape[-1]} channels")
        out: Dict[str, Any] = {"q": self.encode(images[..., :3])}
        if self.ssl_method == "simclr":
            out["z2"] = self.encode(images[..., 3:6])
        elif self.ssl_method == "clsa" and isinstance(batch, dict):
            strong = []
            while f"images_strong_{len(strong)}" in batch:
                strong.append(self.encode(
                    batch[f"images_strong_{len(strong)}"]))
            out["q_strong"] = tuple(strong)
        return out


_FACTORIES = {"res50": modified_resnet_R50, "res101": modified_resnet_R101,
              "vitb32": visual_transformer_B32,
              "vitb16": visual_transformer_B16}


def _build_ssl(method: str, kwargs: dict, device=None) -> SSLModel:
    """ssl_builders.py:155-186: ``image_encode`` goes to the tower
    (``embed_dim`` 2048 by default, and ``attnpool_all_res`` on for the
    ResNets, so that CLSA's strong views of every size pool alike), the
    method kwargs under ``ssl`` or flat beside it; the head's width
    defaults to the tower's ``embed_dim``, SimCLR's temperature to 0.5."""
    kwargs = dict(kwargs or {})
    image_kwargs = dict(kwargs.pop("image_encode", None) or {})
    dtype = as_dtype(kwargs.pop("dtype", None))
    image_kwargs.setdefault("dtype", dtype)
    arch = kwargs.pop("arch", "res50")
    image_kwargs.setdefault("embed_dim", 2048)
    if arch.startswith("res"):
        image_kwargs.setdefault("attnpool_all_res", True)
    ssl = dict(kwargs.pop("ssl", None) or {})
    ssl.update(kwargs)
    ssl.setdefault("hidden_dim", int(image_kwargs["embed_dim"]))
    if method == "simclr":
        ssl.setdefault("T", 0.5)  # simclr_builder.py
    visual = _FACTORIES[arch](device=device, **image_kwargs)
    return SSLModel(visual, ssl_method=method, dtype=dtype, device=device,
                    **ssl)


def _register() -> None:
    for method in ("moco", "simclr", "clsa"):
        for arch in _FACTORIES:
            def build(method=method, arch=arch, device=None, **kwargs):
                kwargs.setdefault("arch", arch)
                return _build_ssl(method, kwargs, device)

            MODELS.register(build, name=f"{method}_{arch}")


_register()

