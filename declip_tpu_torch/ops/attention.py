"""Multi-head attention compute op (port of declip_tpu/ops/attention.py).

``impl`` keeps the JAX package's config values:

- ``'auto'`` and ``'pallas'`` send self-attention (Lq == Lk) to
  :func:`flash_attention` — the Hopper kernels on CUDA tensors (K1, and K2
  for the gradient), at every length, and their plain versions on CPU
  tensors. Gradients flow through it. The JAX package's TPU
  crossover (``_PALLAS_MIN_LEN = 224``, measured on a v5e) is not carried
  over; a threshold for the H100 would have to come from an H100
  measurement.
- ``'xla'`` (only ever an explicit config choice) and cross-attention take
  :func:`attention_plain`, differentiated by torch autograd. The one
  cross-attention on a main path is ModifiedResNet's pooled query (Lq = 1
  against HW + 1 keys, models/resnet.py): the JAX package sends it to XLA
  (ops/attention.py:80-90 there), and this is that path's counterpart, not
  K1's; a one-row query has no Pallas kernel to port.
"""

from __future__ import annotations

from typing import Optional

import torch

from declip_tpu_torch.ops.flash_attention import attention_plain, flash_attention

IMPLS = ("auto", "pallas", "xla")


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Batched MHA core. Shapes ``[B, H, L, Dh]`` -> ``[B, H, Lq, Dh]``."""
    if impl not in IMPLS:
        raise ValueError(f"attn impl {impl!r} not in {IMPLS}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl != "xla" and q.shape[-2] == k.shape[-2]:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return attention_plain(q, k, v, causal, scale)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, D/H], contiguous (the layout the kernel takes)."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, Dh] -> [B, L, H*Dh]"""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)
