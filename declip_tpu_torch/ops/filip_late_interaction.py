"""FILIP late interaction, forward and backward: the Hopper kernels and their
plain versions.

Replaces declip_tpu/ops/filip_pallas.py (three Pallas TPU kernels). The
kernels are K3 (the forward), K4 (the gradient of the query side) and K5
(the gradient of the key side), all in ``csrc/filip_li.cu``: CUDA C++ for
sm_90a with a plain C interface, loaded with ctypes. K3 writes down which
key tokens win each max, as a bit mask, and K4 and K5 read it instead of
recomputing the similarities; the source says what bounds them on an H100
and how the design answers that. K3's bf16 route runs on the tensor cores
(mma.sync, fp32 accumulation), its fp32 route on the CUDA cores.

``raw[b, l] = mean_n max_m <d1[b, n], d2[l, m]>`` for d1 ``[B, N1, D]`` and
d2 ``[GB, N2, D]`` (fp32 or bf16), fp32 out; the gradient routes
``g[b, l] / (N1 * ties)`` to each max winner, so exact ties split it evenly,
as jnp.max autodiff does (and torch.amax; torch.max(dim) would not).

The winners are int32 ``[B*N1, GB, ceil(N2/32)]``: bit ``m % 32`` of word
``m // 32`` is set exactly when the similarity of query row ``r`` (item
``r // N1``, token ``r % N1``) with key token ``m`` of item ``l`` equals
that item's max; a NaN max sets no bit, and its pair's weights are then all
NaN, as on the plain path.

:func:`late_interaction_logits_kernel` is the entry point, the counterpart
of ``late_interaction_logits_pallas``: ``scale.float() * raw``, so that
autograd gives d(scale) (filip_pallas.py:263). Through
``_LateInteraction``:

- CPU tensors run :func:`late_interaction_raw_plain` and
  :func:`late_interaction_winners_plain` and, for the gradient,
  :func:`late_interaction_bwd_d1_plain` and
  :func:`late_interaction_bwd_d2_plain`: the kernels' dataflow, mask
  included (:func:`late_interaction_bwd_plain` is the end-to-end reference
  the tests hold it to);
- CUDA tensors launch K3, and K4 and K5 for the gradient, or raise on what
  the kernels do not take (dtype, N2 > 128, D > 256, layout, and for K3
  a bf16 tensor that does not start on a 16-byte boundary). There is no
  fallback.

The three kernels are registered operators, ``torch.ops.declip_tpu_torch.
late_interaction_fwd``, ``late_interaction_bwd_d1`` and
``late_interaction_bwd_d2`` (``ops/_oplib.py``): the CUDA
implementation is the launch (:func:`late_interaction_fwd`,
:func:`late_interaction_bwd_d1`, :func:`late_interaction_bwd_d2`, with
their checks and launch counts), the CPU implementation the plain version,
and each has a fake and a FLOP formula, which counts a multiply-add as two
operations: K3 forms every similarity, 2*B*GB*N1*N2*D; K4 and K5 gather
and scatter over the winners, one winner for each query token and key
item (ties, which real-valued features meet with probability zero, are
not counted), 2*B*N1*GB*D each. The plain versions of K4 and K5 multiply
by a dense weight over all N2 key tokens, so a count through them would
be N2 times higher: the formula counts what the kernel does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from declip_tpu_torch.ops import _build, _oplib
from declip_tpu_torch.ops.flash_attention import check_aligned

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
    """``(dd1, dd2)`` for the fp32 gradient ``g`` [B, GB] of the raw
    logits, from d1 and d2 alone: the end-to-end reference that the mask
    route (K3's winners, then K4 and K5 or their plain versions) is held to.

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


def _words(n2: int) -> int:
    return (n2 + 31) // 32


def late_interaction_winners_plain(d1: torch.Tensor,
                                   d2: torch.Tensor) -> torch.Tensor:
    """The winners K3 writes, from :func:`_similarities`: int32
    ``[B*N1, GB, ceil(N2/32)]``, bit ``m % 32`` of word ``m // 32`` set
    where similarity ``m`` equals its key item's max (a NaN max: none)."""
    b, n1, _ = d1.shape
    gb, n2, _ = d2.shape
    sim = _similarities(d1, d2)  # [B, GB, N1, N2]
    win = (sim == sim.amax(dim=-1, keepdim=True)).permute(0, 2, 1, 3)
    words = _words(n2)
    win = torch.nn.functional.pad(win.reshape(b * n1, gb, n2),
                                  (0, 32 * words - n2))
    bits = torch.arange(32, dtype=torch.int64, device=d1.device)
    packed = (win.reshape(b * n1, gb, words, 32).long() << bits).sum(-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


def _winner_weights(winners: torch.Tensor, g: torch.Tensor,
                    n2: int) -> torch.Tensor:
    """``[B*N1, GB, N2]`` fp32: ``g / (N1 * ties)`` times each token's
    winner bit, the product ``late_interaction_bwd_plain`` forms."""
    r, gb, words = winners.shape
    n1 = r // g.shape[0]
    bits = torch.arange(32, dtype=torch.int32, device=winners.device)
    win = ((winners[..., None] >> bits) & 1).reshape(r, gb, 32 * words)
    win = win[..., :n2].float()
    ties = win.sum(dim=-1, keepdim=True)
    return g.float().repeat_interleave(n1, dim=0)[..., None] / (n1 * ties) \
        * win


def late_interaction_bwd_d1_plain(winners: torch.Tensor, d2: torch.Tensor,
                                  g: torch.Tensor) -> torch.Tensor:
    """K4's plain version: ``dd1 [B, N1, D]`` in d2's dtype from K3's
    winners, d2 and the fp32 gradient ``g`` [B, GB] of the raw logits."""
    w = _winner_weights(winners, g, d2.shape[1])
    dd1 = torch.einsum("rlm,lmd->rd", w, d2.float())
    return dd1.reshape(g.shape[0], -1, d2.shape[2]).to(d2.dtype)


def late_interaction_bwd_d2_plain(winners: torch.Tensor, d1: torch.Tensor,
                                  g: torch.Tensor, n2: int) -> torch.Tensor:
    """K5's plain version: ``dd2 [GB, N2, D]`` in d1's dtype from K3's
    winners, d1, ``g`` and the key tokens' count N2."""
    w = _winner_weights(winners, g, n2)
    dd2 = torch.einsum("rlm,rd->lmd", w, d1.reshape(-1, d1.shape[2]).float())
    return dd2.to(d1.dtype)


def _library() -> ctypes.CDLL:
    """The loaded ``csrc/filip_li.cu``, its C signatures declared once."""
    lib = _build.load(_SOURCE)
    if lib.filip_li_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.filip_li_fwd.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.filip_li_bwd_workspace.argtypes = [i] * 7
        lib.filip_li_bwd_workspace.restype = ctypes.c_size_t
        for fn in (lib.filip_li_bwd_d1, lib.filip_li_bwd_d2):
            fn.argtypes = [vp] * 5 + [i] * 6 + [vp]
        for fn in (lib.filip_li_fwd, lib.filip_li_bwd_d1, lib.filip_li_bwd_d2):
            fn.restype = ctypes.c_int
    return lib


def _check_features(n2: Optional[int], *xs: torch.Tensor) -> None:
    """Feature tensors as the kernels take them: d1 [B, N1, D] and d2
    [GB, N2, D] for K3, d2 for K4, d1 for K5 (``n2`` None: the last
    tensor's N2)."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(
            f"the late-interaction kernels take CUDA tensors; got {x.device} "
            f"(the *_plain functions are the CPU versions)")
    if any(t.dim() != 3 or t.shape[2] != x.shape[2] for t in xs):
        raise ValueError(
            f"the kernels take d1 [B, N1, D] and d2 [GB, N2, D]; got "
            f"{[tuple(t.shape) for t in xs]}")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in xs):
        raise ValueError(
            f"the kernels take float32 or bfloat16 d1, d2 of one dtype; got "
            f"{[t.dtype for t in xs]}")
    n2 = xs[-1].shape[1] if n2 is None else n2
    if n2 > MAX_N2:
        raise ValueError(
            f"the kernels take at most {MAX_N2} key tokens; got N2 = {n2}")
    if x.shape[2] > MAX_D:
        raise ValueError(
            f"the kernels take a feature dim of at most {MAX_D}; got D = "
            f"{x.shape[2]}")
    if n2 < 1 or any(min(t.shape) == 0 for t in xs):
        raise ValueError("the kernels take non-empty d1 and d2")
    if any(t.device != x.device for t in xs):
        raise ValueError("d1 and d2 must lie on one CUDA device")
    if not all(t.is_contiguous() for t in xs):
        raise ValueError("the kernels take contiguous d1 and d2")


def _check_bwd_inputs(winners: torch.Tensor, x: torch.Tensor,
                      g: torch.Tensor, dims: Tuple[int, ...]) -> None:
    """K4's or K5's winners and g against the (B, N1, GB, N2, D) that the
    feature tensor ``x`` and g imply."""
    b, n1, gb, n2, _ = dims
    if g.shape != (b, gb) or g.dtype != torch.float32 \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(
            f"g must be a contiguous fp32 [B, GB] tensor on the features' "
            f"device; got {tuple(g.shape)} {g.dtype} {g.device}")
    want = (b * n1, gb, _words(n2))
    if winners.shape != want or winners.dtype != torch.int32 \
            or winners.device != x.device or not winners.is_contiguous():
        raise ValueError(
            f"winners must be K3's contiguous int32 {want} tensor on the "
            f"features' device; got {tuple(winners.shape)} {winners.dtype} "
            f"{winners.device}")


def _dims(d1, d2):
    b, n1, d = d1.shape
    gb, n2, _ = d2.shape
    return b, n1, gb, n2, d


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def late_interaction_fwd(d1: torch.Tensor, d2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(raw [B, GB] fp32, winners)`` on CUDA tensors; raises on what
    the kernel does not take (its bf16 route copies rows 16 bytes at a
    time, so a bf16 d1 or d2 must start on a 16-byte boundary)."""
    _check_features(None, d1, d2)
    check_aligned(d1=d1, d2=d2)
    b, n1, gb, n2, d = _dims(d1, d2)
    rowmax = torch.empty(b * n1, gb, dtype=torch.float32, device=d1.device)
    raw = torch.empty(b, gb, dtype=torch.float32, device=d1.device)
    winners = torch.empty(b * n1, gb, _words(n2), dtype=torch.int32,
                          device=d1.device)
    lib = _library()
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = lib.filip_li_fwd(d1.data_ptr(), d2.data_ptr(),
                               rowmax.data_ptr(), raw.data_ptr(),
                               winners.data_ptr(), b, n1, gb, n2, d,
                               _DTYPE_CODES[d1.dtype], stream)
    _raise_on(err, "filip_li_fwd")
    late_interaction_fwd.launches += 1
    return raw, winners


@functools.lru_cache(maxsize=None)
def _bwd_workspace(which: int, dims: Tuple[int, ...], dtype: int,
                   device: int) -> int:
    """fp32 elements of K4's (which 1) or K5's (2) partial sums, 0 where
    the kernel writes its output itself; the kernels' source sets the split
    count from the device's SMs."""
    with torch.cuda.device(device):
        return _library().filip_li_bwd_workspace(which, *dims, dtype)


def _bwd(which: int, winners, x, g, dims):
    lib = _library()
    code = _DTYPE_CODES[x.dtype]
    part = torch.empty(_bwd_workspace(which, dims, code, x.device.index),
                       dtype=torch.float32, device=x.device)
    b, n1, gb, n2, d = dims
    out = torch.empty((b, n1, d) if which == 1 else (gb, n2, d),
                      dtype=x.dtype, device=x.device)
    fn, name = ((lib.filip_li_bwd_d1, "filip_li_bwd_d1") if which == 1
                else (lib.filip_li_bwd_d2, "filip_li_bwd_d2"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(winners.data_ptr(), x.data_ptr(), g.data_ptr(),
                 part.data_ptr(), out.data_ptr(), *dims, code, stream)
    _raise_on(err, name)
    return out


def late_interaction_bwd_d1(winners: torch.Tensor, d2: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """K4: ``dd1 [B, N1, D]`` in d2's dtype from K3's winners, d2 and the
    fp32 gradient ``g`` [B, GB] of the raw logits, on CUDA tensors; raises
    on what the kernel does not take. Forms no similarity."""
    if g.dim() != 2 or winners.dim() != 3 or g.shape[0] == 0 \
            or winners.shape[0] % g.shape[0]:
        raise ValueError(
            f"K4 takes winners [B*N1, GB, words] and g [B, GB]; got "
            f"{tuple(winners.shape)}, {tuple(g.shape)}")
    _check_features(None, d2)
    b = g.shape[0]
    dims = (b, winners.shape[0] // b, *d2.shape)
    _check_bwd_inputs(winners, d2, g, dims)
    out = _bwd(1, winners, d2, g, dims)
    late_interaction_bwd_d1.launches += 1
    return out


def late_interaction_bwd_d2(winners: torch.Tensor, d1: torch.Tensor,
                            g: torch.Tensor, n2: int) -> torch.Tensor:
    """K5: ``dd2 [GB, N2, D]`` in d1's dtype from K3's winners, d1, ``g``
    and the key tokens' count ``n2``, as K4."""
    if g.dim() != 2:
        raise ValueError(f"K5 takes g [B, GB]; got {tuple(g.shape)}")
    _check_features(n2, d1)
    dims = (*d1.shape[:2], g.shape[1], n2, d1.shape[2])
    _check_bwd_inputs(winners, d1, g, dims)
    out = _bwd(2, winners, d1, g, dims)
    late_interaction_bwd_d2.launches += 1
    return out


def _fwd_cpu(d1, d2):
    return (late_interaction_raw_plain(d1, d2),
            late_interaction_winners_plain(d1, d2))


def _fwd_fake(d1, d2):
    b, n1, gb, n2, _ = _dims(d1, d2)
    return (d1.new_empty(b, gb, dtype=torch.float32),
            d1.new_empty(b * n1, gb, _words(n2), dtype=torch.int32))


def _fwd_flops(d1_shape, d2_shape, *args, **kwargs) -> int:
    (b, n1, d), (gb, n2, _) = d1_shape, d2_shape
    return 2 * b * gb * n1 * n2 * d


def _bwd_flops(winners_shape, x_shape, g_shape, *args, **kwargs) -> int:
    # one winner for each (query row, key item): B*N1*GB rows of D
    return 2 * winners_shape[0] * g_shape[1] * x_shape[-1]


# K3 -> (raw, winners)
li_fwd_op = _oplib.define(
    "late_interaction_fwd(Tensor d1, Tensor d2) -> (Tensor, Tensor)",
    cuda=late_interaction_fwd, cpu=_fwd_cpu, fake=_fwd_fake,
    flops=_fwd_flops)
# K4 -> dd1
li_bwd_d1_op = _oplib.define(
    "late_interaction_bwd_d1(Tensor winners, Tensor d2, Tensor g) -> Tensor",
    cuda=late_interaction_bwd_d1, cpu=late_interaction_bwd_d1_plain,
    fake=lambda winners, d2, g: d2.new_empty(
        g.shape[0], winners.shape[0] // g.shape[0], d2.shape[2]),
    flops=_bwd_flops)
# K5 -> dd2
li_bwd_d2_op = _oplib.define(
    "late_interaction_bwd_d2(Tensor winners, Tensor d1, Tensor g, int n2) "
    "-> Tensor",
    cuda=late_interaction_bwd_d2, cpu=late_interaction_bwd_d2_plain,
    fake=lambda winners, d1, g, n2: d1.new_empty(g.shape[1], n2,
                                                 d1.shape[2]),
    flops=_bwd_flops)


class _LateInteraction(torch.autograd.Function):
    """The raw logits with their gradient through the three operators: K3,
    K4 and K5 on CUDA tensors, the plain versions of the same dataflow on
    CPU tensors (filip_pallas.py:149-221's custom_vjp). The forward saves
    K3's winners; the backward forms no similarity."""

    @staticmethod
    def forward(ctx, d1, d2):
        raw, winners = li_fwd_op(d1, d2)
        ctx.save_for_backward(d1, d2, winners)
        return raw

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        d1, d2, winners = ctx.saved_tensors
        g = g.float().contiguous()
        need_d1, need_d2 = ctx.needs_input_grad
        return (li_bwd_d1_op(winners, d2, g) if need_d1 else None,
                li_bwd_d2_op(winners, d1, g, d2.shape[1]) if need_d2
                else None)


def late_interaction_logits_kernel(d1: torch.Tensor, d2: torch.Tensor,
                                   scale: torch.Tensor) -> torch.Tensor:
    """dense_1 [B, N1, D] (normalized), dense_2_gathered [GB, N2, D] ->
    ``scale * raw`` [B, GB] fp32 (see the module docstring)."""
    if d1.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the late interaction runs on CPU or CUDA tensors; got "
            f"{d1.device}")
    return scale.float() * _LateInteraction.apply(d1, d2)


# calls of each CUDA kernel's wrapper in this process (CPU calls do not
# count); one K3 call is two launches (the row maxima and winners, then their
# mean), one K4 or K5 call one or two (the split sums, then their reduction)
late_interaction_fwd.launches = 0
late_interaction_bwd_d1.launches = 0
late_interaction_bwd_d2.launches = 0
