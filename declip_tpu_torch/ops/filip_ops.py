"""FILIP token-wise late-interaction similarity (port of
declip_tpu/ops/filip_ops.py).

``logits[b, l] = scale * mean_n max_m <d1[b, n], d2[l, m]>``: max over the
other side's tokens, mean over own tokens (prototype/model/filip.py:96-105).

Two implementations, chosen by :func:`dispatch_late_interaction`:

- the kernel route (the default, ``impl: pallas`` as the JAX package names
  it): :func:`late_interaction_logits_kernel`, K3-K5 on CUDA tensors and
  their plain versions on CPU tensors;
- ``impl: xla``: :func:`late_interaction_logits`, the chunked path in plain
  torch on any device, each chunk's similarity recomputed in the backward
  (``torch.utils.checkpoint``, as ``jax.checkpoint`` there), so that the
  [B, C, N1, N2] similarity of every chunk is never held at once.
"""

from __future__ import annotations

import os

import torch
import torch.utils.checkpoint

from declip_tpu_torch.ops.filip_late_interaction import (
    late_interaction_logits_kernel,
    late_interaction_raw_plain,
)

IMPLS = ("pallas", "xla")


def late_interaction_logits(dense_1: torch.Tensor,
                            dense_2_gathered: torch.Tensor,
                            scale: torch.Tensor,
                            chunk_size: int = 512) -> torch.Tensor:
    """dense_1 [B, N1, D] (normalized), dense_2_gathered [GB, N2, D]
    -> [B, GB] fp32 logits. The products accumulate in fp32 (operands
    widened, which is exact for bf16); ``amax`` splits the gradient of a
    tied max evenly, as ``jnp.max`` does."""
    remat = torch.is_grad_enabled()
    outs = []
    for start in range(0, dense_2_gathered.shape[0], chunk_size):
        chunk = dense_2_gathered[start:start + chunk_size]
        if remat:
            outs.append(torch.utils.checkpoint.checkpoint(
                late_interaction_raw_plain, dense_1, chunk,
                use_reentrant=False))
        else:
            outs.append(late_interaction_raw_plain(dense_1, chunk))
    return scale.float() * torch.cat(outs, dim=1)


def dispatch_late_interaction(cfg=None):
    """Config/env-selected late-interaction implementation.

    Order, as in the JAX package: ``cfg.filip_dense.impl`` >
    ``$DECLIP_FILIP_LI_IMPL`` > the default, the kernel route. The JAX
    package sends N2 > 32 to XLA because Mosaic unrolls one matmul per key
    token; the CUDA kernels loop over key tokens instead and take N2 up to
    128 (every unselected text or ViT-B key set), and raise beyond it:
    there is no quiet detour."""
    impl = None
    if cfg:
        impl = (cfg.get("filip_dense") or {}).get("impl")
    impl = impl or os.environ.get("DECLIP_FILIP_LI_IMPL") or "pallas"
    if impl not in IMPLS:
        raise ValueError(f"filip_dense impl {impl!r} not in {IMPLS}")
    if impl == "pallas":
        return late_interaction_logits_kernel
    return late_interaction_logits
