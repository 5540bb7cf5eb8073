"""NNCLR nearest-neighbour feature queue (port of
declip_tpu/models/memory_bank.py).

Rebuilds prototype/model/utils/nnclr_modules/{memory_bank,nn_memory_bank}.py
as the JAX package does: the bank is explicit train-step state, a
``BankState`` of a [size, dim] fp32 tensor and the next write position, an
int on the host (the batch size is known there, so the ring arithmetic
needs no device read). ``enqueue`` writes in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class BankState:
    bank: torch.Tensor  # [size, dim] rows, L2-normalized at init
    ptr: int  # next write position


def init_bank(generator: torch.Generator, size: int, dim: int,
              dtype=torch.float32, device=None) -> BankState:
    """Random normalized rows (memory_bank.py:55-65), drawn on the CPU from
    ``generator`` and moved to ``device``."""
    bank = torch.randn(size, dim, generator=generator, dtype=torch.float32)
    bank = bank / torch.linalg.vector_norm(bank, dim=-1, keepdim=True)
    return BankState(bank.to(device=device, dtype=dtype), 0)


@torch.no_grad()
def enqueue(state: BankState, batch: torch.Tensor) -> BankState:
    """Ring write of a [B, dim] batch at ``ptr``, in place.

    As in the JAX package (a delta from memory_bank.py:70-87, which writes a
    partial batch and drops the tail on wrap): the write start is clamped to
    ``size - B`` so that the whole batch lands, then the pointer wraps to 0.
    """
    size, b = state.bank.shape[0], batch.shape[0]
    start = min(state.ptr, size - b)
    state.bank[start:start + b] = batch.to(state.bank.dtype)
    state.ptr = 0 if state.ptr + b >= size else state.ptr + b
    return state


@torch.no_grad()
def nearest_indices(state: BankState, x: torch.Tensor,
                    topk: int = 1) -> torch.Tensor:
    """[B, topk] indices of the bank rows nearest each row of x by cosine
    similarity (nn_memory_bank.py:42-65), nearest first.

    The bank is cast to x's dtype, and the similarity is taken in fp32 from
    those values (JAX's ``preferred_element_type=float32``). As there, x is
    not normalized (a positive scale per query moves no index) and the
    similarity's columns are divided by the bank's row norms instead of
    normalizing a copy of the bank. k = 1 is an argmax, which takes the
    first of tied maxima, as ``jnp.argmax``; k > 1 takes ties in index
    order, as ``lax.top_k``."""
    bank = state.bank.to(x.dtype)
    if x.dtype != torch.float32 and x.is_cuda:
        # bf16 products on the tensor cores, fp32 sums and result
        sim = torch.mm(x, bank.t(), out_dtype=torch.float32)
    else:
        # the same products (exact in fp32) and sums where mm has no
        # out_dtype (the CPU)
        sim = x.float() @ bank.float().t()
    # one fp32 reduction over the cast bank, not an fp32 copy and its square
    norms = torch.linalg.vector_norm(bank, dim=-1, dtype=torch.float32)
    sim = sim / (norms + 1e-10)
    if topk == 1:
        return torch.argmax(sim, dim=-1, keepdim=True)
    return torch.sort(sim, dim=-1, descending=True, stable=True).indices[
        :, :topk]


@torch.no_grad()
def query_topk(state: BankState, x: torch.Tensor,
               topk: int = 1) -> Tuple[torch.Tensor, ...]:
    """The ``topk`` nearest bank rows of each row of x (``nearest_indices``):
    a tuple of k [B, dim] tensors in x's dtype, nearest first."""
    idx = nearest_indices(state, x, topk)
    return tuple(state.bank[idx[:, i]].to(x.dtype) for i in range(topk))
