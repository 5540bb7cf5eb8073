"""The ``declip_tpu_torch::`` operator library: each hand-written kernel
as one registered operator.

:func:`define` registers a schema with a CUDA implementation (the kernel's
launch), a CPU implementation (its plain version), a fake (shapes and
dtypes, for ``torch.export`` and fake tensors) and a FLOP formula (for
``torch.utils.flop_counter.FlopCounterMode``), and returns the operator's
overload, which the callers keep and call.

It goes through ``torch.library.Library`` ``define``/``impl``, not
``torch.library.custom_op``: a call then runs the dispatcher in C++ and
the implementation alone in Python. ``custom_op`` adds a Python autograd
kernel, an aliasing check and a ``torch._dynamo.disable`` wrapper to each
call, and its first call imports ``torch._dynamo`` (with sympy, about 850
modules). No operator here needs an autograd kernel: the
``autograd.Function``s that call them (``_FlashAttention``,
``_LateInteraction``) hold the gradients, and call them with grad mode
off, as any caller without a gradient does.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "declip_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(schema: str, cuda: Callable, cpu: Callable, fake: Callable,
           flops: Callable) -> torch._ops.OpOverload:
    """Register ``NAMESPACE::<schema>`` -> its default overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    return packet.default
