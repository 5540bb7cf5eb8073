"""Parameter census and FLOP estimates (port of declip_tpu/utils/flops.py).

Parameters are counted over a module's parameters, never its buffers
(BatchNorm's running statistics are ``batch_stats`` in the JAX package,
outside ``params``), so the totals are the JAX package's over ``params``.
The top modules carry the port's names: the CLIP family's text tower is
``encode_text`` here and ``text`` there; the JAX package stacks each
tower's residual blocks into one leaf a kind, so ``tensors`` counts more
tensors here for the same parameters.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one call,
where the JAX package reads XLA's cost analysis of the compiled function:
matrix products and convolutions by PyTorch's formulas, and the port's
kernels (K1-K5, registered operators) by their own formulas
(ops/flash_attention.py, ops/filip_late_interaction.py), on the card and
on the CPU alike. Elementwise work, reductions and normalisation count
nothing, as in PyTorch's counter.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from torch import nn
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["count_params", "count_params_by_top_module", "estimate_flops",
           "flops_by_operator"]


def count_params(module: nn.Module) -> Dict[str, float]:
    params = list(module.parameters())
    total = sum(p.numel() for p in params)
    return {"total": total, "total_M": total / 1e6, "tensors": len(params)}


def count_params_by_top_module(module: nn.Module) -> Dict[str, int]:
    """Parameter count under each top-level name (a child module, or a
    parameter held by ``module`` itself)."""
    out: Dict[str, int] = {}
    for name, p in module.named_parameters():
        top = name.split(".", 1)[0]
        out[top] = out.get(top, 0) + p.numel()
    return out


def flops_by_operator(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` -> FLOPs
    by operator name (``declip_tpu_torch.flash_attn_fwd``, ``aten.mm``...),
    for operators that counted any."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {str(op): int(n)
            for op, n in counter.get_flop_counts().get("Global", {}).items()
            if n}


def estimate_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn`` (it runs once), or None where nothing
    was counted."""
    return float(sum(flops_by_operator(fn, *args, **kwargs).values())) or None
