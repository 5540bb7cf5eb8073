"""Fused self-attention, forward and backward: the Hopper kernels and their
plain versions.

Replaces declip_tpu/ops/flash_attention.py (two Pallas TPU kernels). The
kernels are ``csrc/flash_attn_fwd.cu`` (K1, the forward) and
``csrc/flash_attn_bwd.cu`` (K2, the backward): CUDA C++ for sm_90a with a
plain C interface, loaded with ctypes. Each takes one of two routes by
dtype:

- bfloat16 (training): the tensor cores, through warp-level ``mma.sync``
  with bf16 operands and fp32 accumulation, building blocks in
  ``csrc/attn_mma.cuh``. K2 is one kernel at L <= 128 (every training
  shape) and three above. The bf16 tensors they read must start on
  16-byte boundaries;
- float32 (serving, the fp32 checks): K1 on the tensor cores in split
  TF32, each fp32 product taken as three TF32 products (hi.hi + hi.lo +
  lo.hi), which keeps fp32-grade accuracy where TF32 alone keeps about
  three digits; K2 on the CUDA cores in fp32 FMAs.

Each source says what bounds it on an H100 and how its design answers that.

``flash_attention`` takes ``[B, H, L, Dh]`` q, k, v:

- on CPU tensors it runs :func:`attention_plain`, and its gradient
  :func:`attention_bwd_plain`;
- on CUDA tensors it launches K1, and K2 for the gradient, or raises on what
  the kernels do not take (dtype, Dh, layout, alignment). There is no
  fallback.

Where autograd needs a gradient, the call goes through ``_FlashAttention``
(the ``jax.custom_vjp`` of the JAX package): the forward also keeps each
row's log-sum-exp, and the backward is K2 on the card. Without a gradient
(serving) K1 runs alone and writes no log-sum-exp.

Both kernels are registered operators, ``torch.ops.declip_tpu_torch.
flash_attn_fwd`` and ``flash_attn_bwd`` (``ops/_oplib.py``):
the CUDA implementation is the launch (:func:`_forward_kernel`,
:func:`flash_attention_bwd`, with their checks and launch counts), the
CPU implementation the plain version, and each has a fake (shapes and
dtypes) and a FLOP formula. So ``torch.export`` keeps K1 in a graph as one
node, and ``torch.utils.flop_counter.FlopCounterMode`` counts each call
by its formula, on the card and on the CPU alike. The formulas count a
multiply-add as two operations and a masked (causal) product in full, as
the plain version's matmuls are counted: K1 is two products of
``B*H*L*L*Dh`` multiply-adds (QK^T, PV), 4*B*H*L^2*Dh; K2 is five (the
recomputed scores, dV, dP, dQ, dK), 10*B*H*L^2*Dh, 2.5 times K1.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from declip_tpu_torch.ops import _build, _oplib

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)


def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``[B, H, Lq, Dh] x [B, H, Lk, Dh] -> [B, H, Lq, Dh]`` in plain torch.

    The TPU kernel's arithmetic (flash_attention.py:52-68): fp32 scores,
    masked keys at -1e30, fp32 softmax, P cast to v's dtype, P.V with fp32
    accumulation, output in q's dtype. The causal mask keeps key <= query."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(*s.shape[-2:], s.device), -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """fp32 ``[B, H, Lq]``: each row's log-sum-exp of the masked fp32
    scores, what K1 writes beside its output for K2."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(*s.shape[-2:], s.device), -1e30)
    return torch.logsumexp(s, dim=-1)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of self-attention for the output gradient ``do``,
    all ``[B, H, L, Dh]``: K2's plain version.

    The TPU kernel's arithmetic step by step (flash_attention.py:84-116):
    P recomputed in fp32 from masked fp32 scores; dV = P^T dO with P rounded
    to the operand dtype; dP = dO V^T; dS = P o (dP - rowsum(dP o P)),
    masked, times scale, rounded to the operand dtype; dQ = dS K and
    dK = dS^T Q. Every product accumulates in fp32 (operands widened, which
    is exact); the outputs are in the operand dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    keep = _causal_keep(*s.shape[-2:], s.device) if causal else None
    if causal:
        s = s.masked_fill(~keep, -1e30)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if causal:
        ds = ds.masked_fill(~keep, 0.0)
    ds = (ds * scale).to(dt).float()
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _library(name: str, n_args: int) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu``; its one function takes pointers and
    ints in the order of the C signature (declared here once)."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers, then (bh, L, dh, dtype, causal), scale, stream
        fn.argtypes = [vp] * n_args + [i] * 5 + [f, vp]
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(
            f"flash_attention takes [B, H, L, Dh]; got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "the kernel is self-attention: q, k, v must share one shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes float32 or bfloat16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"the kernel takes head dim in {HEAD_DIMS}; got {q.shape[-1]}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k, v")
    check_aligned(q=q, k=k, v=v)


def check_aligned(**tensors) -> None:
    """The bf16 kernels read rows 16 bytes at a time (cp.async, vector
    loads), so each bf16 tensor they read must start on a 16-byte boundary;
    a view at another storage offset raises here instead of faulting on
    the card."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(
                f"the bf16 kernel takes {name} starting on a 16-byte "
                f"boundary; got address {t.data_ptr():#x} (a view at "
                f"storage offset {t.storage_offset()})")


def _forward_kernel(q, k, v, causal: bool, scale: float, with_lse: bool):
    """Launch K1 -> (o, lse or None); lse is fp32 ``[B, H, L]``."""
    _check_kernel_inputs(q, k, v)
    b, h, length, dh = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, length, dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _library("flash_attn_fwd", 5).flash_attn_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b * h, length, dh,
                 _DTYPE_CODES[q.dtype], int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors: ``(dq, dk, dv)`` from the forward's inputs, its
    output ``o`` and log-sum-exp ``lse`` (fp32 ``[B, H, L]``), and the output
    gradient ``do``. Raises on what the kernel does not take."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_bwd launches the CUDA kernel; got {q.device} "
            f"tensors (attention_bwd_plain is the CPU version)")
    _check_kernel_inputs(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q's shape, dtype and device; got "
                f"{tuple(t.shape)} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the kernel takes a contiguous {name}")
    check_aligned(o=o, do=do)
    b, h, length, dh = q.shape
    if (lse is None or lse.shape != (b, h, length)
            or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(
            "lse must be the forward's contiguous fp32 [B, H, L] log-sum-exp")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(b, h, length, dtype=torch.float32, device=q.device)
    fn = _library("flash_attn_bwd", 10).flash_attn_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, length,
                 dh, _DTYPE_CODES[q.dtype], int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attn_bwd launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty(0, dtype=torch.float32)


def _fwd_cuda(q, k, v, causal, scale, with_lse):
    o, lse = _forward_kernel(q, k, v, causal, scale, with_lse)
    return o, (lse if with_lse else _no_lse(q))


def _fwd_cpu(q, k, v, causal, scale, with_lse):
    o = attention_plain(q, k, v, causal, scale)
    return o, (attention_lse_plain(q, k, causal, scale) if with_lse
               else _no_lse(q))


def _fwd_fake(q, k, v, causal, scale, with_lse):
    return torch.empty_like(q), (q.new_empty(q.shape[:-1],
                                             dtype=torch.float32)
                                 if with_lse else _no_lse(q))


def _bwd_cuda(q, k, v, o, lse, do, causal, scale):
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               scale=scale)


def _bwd_cpu(q, k, v, o, lse, do, causal, scale):
    # the plain version recomputes P from q and k: it reads neither o nor
    # lse
    return attention_bwd_plain(q, k, v, do, causal, scale)


def _bwd_fake(q, k, v, o, lse, do, causal, scale):
    return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)


def _attention_flops(q_shape) -> int:
    """Multiply-adds times two of one ``[B, H, L, L] x Dh`` product."""
    b, h, length, dh = q_shape
    return 2 * b * h * length * length * dh


# K1 -> (o, lse): lse fp32 [B, H, L] with with_lse, else an empty fp32
# tensor
flash_attn_fwd_op = _oplib.define(
    "flash_attn_fwd(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
    "bool with_lse) -> (Tensor, Tensor)",
    cuda=_fwd_cuda, cpu=_fwd_cpu, fake=_fwd_fake,
    flops=lambda q_shape, *a, **kw: 2 * _attention_flops(q_shape))
# K2 -> (dq, dk, dv)
flash_attn_bwd_op = _oplib.define(
    "flash_attn_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
    "Tensor do, bool causal, float scale) -> (Tensor, Tensor, Tensor)",
    cuda=_bwd_cuda, cpu=_bwd_cpu, fake=_bwd_fake,
    flops=lambda q_shape, *a, **kw: 5 * _attention_flops(q_shape))


class _FlashAttention(torch.autograd.Function):
    """Self-attention with its gradient through the two operators: K1 and
    K2 on CUDA tensors, the plain versions on CPU tensors
    (flash_attention.py:141-193's custom_vjp). The CPU forward keeps no
    log-sum-exp: the plain backward does not read it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attn_fwd_op(q, k, v, causal, scale,
                                   q.device.type != "cpu")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # merge_heads transposes, so the incoming gradient is a strided view
        grads = flash_attn_bwd_op(q, k, v, o, lse, do.contiguous(),
                                  ctx.causal, ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``[B, H, L, Dh]`` fused self-attention (see the module docstring)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"flash_attention runs on CPU or CUDA tensors; got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attn_fwd_op(q, k, v, causal, scale, False)[0]


# launches of each CUDA kernel in this process (CPU calls do not count); one
# flash_attention_bwd launch is one kernel (bf16, L <= 128) or three (delta,
# dk/dv, dq)
flash_attention.launches = 0
flash_attention_bwd.launches = 0
