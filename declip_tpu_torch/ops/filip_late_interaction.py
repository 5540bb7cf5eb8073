"""FILIP late interaction, forward and backward: the Hopper kernels and their
plain versions.

Replaces declip_tpu/ops/filip_pallas.py (three Pallas TPU kernels). The
kernels are K3 (the forward), K4 (the gradient of the query side) and K5
(the gradient of the key side), all in ``csrc/filip_li.cu``: CUDA C++ for
sm_90a with a plain C interface, loaded with ctypes. They share one
similarity routine, so that all three find the same max winners; the source
says what bounds them on an H100 and how the design answers that.

``raw[b, l] = mean_n max_m <d1[b, n], d2[l, m]>`` for d1 ``[B, N1, D]`` and
d2 ``[GB, N2, D]`` (fp32 or bf16), fp32 out; the gradient routes
``g[b, l] / (N1 * ties)`` to each max winner, so exact ties split it evenly,
as jnp.max autodiff does (and torch.amax; torch.max(dim) would not).

:func:`late_interaction_logits_kernel` is the entry point, the counterpart
of ``late_interaction_logits_pallas``: ``scale.float() * raw``, so that
autograd gives d(scale) (filip_pallas.py:263). Through
``_LateInteraction``:

- CPU tensors run :func:`late_interaction_raw_plain` and, for the gradient,
  :func:`late_interaction_bwd_plain`;
- CUDA tensors launch K3, and K4 and K5 for the gradient, or raise on what
  the kernels do not take (dtype, N2 > 128, D > 256, layout). There is no
  fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from declip_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N2 = 128
MAX_D = 256
_SOURCE = "filip_li"


def _similarities(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """``[B, GB, N1, N2]`` fp32 similarities (operands widened, which is
    exact for bf16; the products accumulate in fp32)."""
    return torch.einsum("bnd,lmd->blnm", d1.float(), d2.float())


def late_interaction_raw_plain(d1: torch.Tensor,
                               d2: torch.Tensor) -> torch.Tensor:
    """K3's plain version: ``[B, N1, D] x [GB, N2, D] -> [B, GB]`` fp32, the
    max over key tokens, then the mean over query tokens."""
    return _similarities(d1, d2).amax(dim=-1).mean(dim=-1)


def late_interaction_bwd_plain(d1: torch.Tensor, d2: torch.Tensor,
                               g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's and K5's plain version: ``(dd1, dd2)`` for the fp32 gradient
    ``g`` [B, GB] of the raw logits.

    The TPU kernel's arithmetic step by step (filip_pallas.py:99-146): the
    similarities recomputed in fp32; ties counted by equality with the max;
    ``W = g / (N1 * ties)`` on the winners and 0 elsewhere; dd1 and dd2 as
    contractions of W with fp32 accumulation, returned in the input dtype."""
    n1 = d1.shape[1]
    sim = _similarities(d1, d2)
    win = (sim == sim.amax(dim=-1, keepdim=True)).float()
    ties = win.sum(dim=-1, keepdim=True)
    w = g.float()[:, :, None, None] / (n1 * ties) * win
    dd1 = torch.einsum("blnm,lmd->bnd", w, d2.float())
    dd2 = torch.einsum("blnm,bnd->lmd", w, d1.float())
    return dd1.to(d1.dtype), dd2.to(d2.dtype)


def _library() -> ctypes.CDLL:
    """The loaded ``csrc/filip_li.cu``, its C signatures declared once."""
    lib = _build.load(_SOURCE)
    if lib.filip_li_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.filip_li_fwd.argtypes = [vp] * 4 + [i] * 6 + [vp]
        lib.filip_li_bwd_workspace.argtypes = [i] * 6
        lib.filip_li_bwd_workspace.restype = ctypes.c_size_t
        for fn in (lib.filip_li_bwd_d1, lib.filip_li_bwd_d2):
            fn.argtypes = [vp] * 5 + [i] * 6 + [vp]
        for fn in (lib.filip_li_fwd, lib.filip_li_bwd_d1, lib.filip_li_bwd_d2):
            fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(d1: torch.Tensor, d2: torch.Tensor,
                         g: torch.Tensor = None) -> None:
    if d1.device.type != "cuda":
        raise ValueError(
            f"the late-interaction kernels take CUDA tensors; got {d1.device} "
            f"(late_interaction_raw_plain / late_interaction_bwd_plain are "
            f"the CPU versions)")
    if d1.dim() != 3 or d2.dim() != 3 or d1.shape[2] != d2.shape[2]:
        raise ValueError(
            f"the kernels take d1 [B, N1, D] and d2 [GB, N2, D]; got "
            f"{tuple(d1.shape)}, {tuple(d2.shape)}")
    if d1.dtype not in _DTYPE_CODES or d2.dtype != d1.dtype:
        raise ValueError(
            f"the kernels take float32 or bfloat16 d1, d2 of one dtype; got "
            f"{d1.dtype}, {d2.dtype}")
    if d2.shape[1] > MAX_N2:
        raise ValueError(
            f"the kernels take at most {MAX_N2} key tokens; got N2 = "
            f"{d2.shape[1]}")
    if d1.shape[2] > MAX_D:
        raise ValueError(
            f"the kernels take a feature dim of at most {MAX_D}; got D = "
            f"{d1.shape[2]}")
    if min(d1.shape) == 0 or min(d2.shape) == 0:
        raise ValueError("the kernels take non-empty d1 and d2")
    if d2.device != d1.device:
        raise ValueError("d1 and d2 must lie on one CUDA device")
    if not (d1.is_contiguous() and d2.is_contiguous()):
        raise ValueError("the kernels take contiguous d1 and d2")
    if g is not None and (g.shape != (d1.shape[0], d2.shape[0])
                          or g.dtype != torch.float32
                          or g.device != d1.device or not g.is_contiguous()):
        raise ValueError(
            f"g must be a contiguous fp32 [B, GB] tensor on d1's device; got "
            f"{tuple(g.shape)} {g.dtype} {g.device}")


def _dims(d1, d2):
    b, n1, d = d1.shape
    gb, n2, _ = d2.shape
    return b, n1, gb, n2, d


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def late_interaction_fwd(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """K3: ``raw [B, GB]`` fp32 on CUDA tensors; raises on what the kernel
    does not take."""
    _check_kernel_inputs(d1, d2)
    b, n1, gb, n2, d = _dims(d1, d2)
    rowmax = torch.empty(b * n1, gb, dtype=torch.float32, device=d1.device)
    raw = torch.empty(b, gb, dtype=torch.float32, device=d1.device)
    lib = _library()
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = lib.filip_li_fwd(d1.data_ptr(), d2.data_ptr(),
                               rowmax.data_ptr(), raw.data_ptr(), b, n1, gb,
                               n2, d, _DTYPE_CODES[d1.dtype], stream)
    _raise_on(err, "filip_li_fwd")
    late_interaction_fwd.launches += 1
    return raw


@functools.lru_cache(maxsize=None)
def _bwd_workspace(which: int, dims: Tuple[int, ...], device: int) -> int:
    """fp32 elements of K4's (which 1) or K5's (2) partial sums; the
    kernels' source sets the split count from the device's SMs."""
    with torch.cuda.device(device):
        return _library().filip_li_bwd_workspace(which, *dims)


def _bwd(which: int, d1, d2, g):
    _check_kernel_inputs(d1, d2, g)
    dims = _dims(d1, d2)
    lib = _library()
    part = torch.empty(_bwd_workspace(which, dims, d1.device.index),
                       dtype=torch.float32, device=d1.device)
    out = torch.empty_like(d1 if which == 1 else d2)
    fn, name = ((lib.filip_li_bwd_d1, "filip_li_bwd_d1") if which == 1
                else (lib.filip_li_bwd_d2, "filip_li_bwd_d2"))
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = fn(d1.data_ptr(), d2.data_ptr(), g.data_ptr(), part.data_ptr(),
                 out.data_ptr(), *dims, _DTYPE_CODES[d1.dtype], stream)
    _raise_on(err, name)
    return out


def late_interaction_bwd_d1(d1: torch.Tensor, d2: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """K4: ``dd1 [B, N1, D]`` in d1's dtype for the fp32 gradient ``g``
    [B, GB] of the raw logits, on CUDA tensors; raises on what the kernel
    does not take."""
    out = _bwd(1, d1, d2, g)
    late_interaction_bwd_d1.launches += 1
    return out


def late_interaction_bwd_d2(d1: torch.Tensor, d2: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """K5: ``dd2 [GB, N2, D]`` in d2's dtype, as K4."""
    out = _bwd(2, d1, d2, g)
    late_interaction_bwd_d2.launches += 1
    return out


class _LateInteraction(torch.autograd.Function):
    """The raw logits with their gradient: K3, K4 and K5 on CUDA tensors,
    the plain versions on CPU tensors (filip_pallas.py:149-221's
    custom_vjp)."""

    @staticmethod
    def forward(ctx, d1, d2):
        ctx.save_for_backward(d1, d2)
        if d1.device.type == "cpu":
            return late_interaction_raw_plain(d1, d2)
        return late_interaction_fwd(d1, d2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        d1, d2 = ctx.saved_tensors
        g = g.float().contiguous()
        if d1.device.type == "cpu":
            return late_interaction_bwd_plain(d1, d2, g)
        need_d1, need_d2 = ctx.needs_input_grad
        return (late_interaction_bwd_d1(d1, d2, g) if need_d1 else None,
                late_interaction_bwd_d2(d1, d2, g) if need_d2 else None)


def late_interaction_logits_kernel(d1: torch.Tensor, d2: torch.Tensor,
                                   scale: torch.Tensor) -> torch.Tensor:
    """dense_1 [B, N1, D] (normalized), dense_2_gathered [GB, N2, D] ->
    ``scale * raw`` [B, GB] fp32 (see the module docstring)."""
    if d1.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the late interaction runs on CPU or CUDA tensors; got "
            f"{d1.device}")
    return scale.float() * _LateInteraction.apply(d1, d2)


# launches of each CUDA kernel in this process (CPU calls do not count); one
# K3 call is two launches (the row maxima, then their mean), one K4 or K5
# call two (the split sums, then their reduction)
late_interaction_fwd.launches = 0
late_interaction_bwd_d1.launches = 0
late_interaction_bwd_d2.launches = 0
