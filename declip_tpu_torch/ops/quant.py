"""Post-training int8 inference for the Dense products (port of
declip_tpu/ops/quant.py).

Dynamic symmetric quantization: inside :func:`int8_inference`, every
product that is an ``nn.Dense`` in the JAX package's towers runs as

    int8(x) @ int8(W) -> int32 sum, times the rows' activation scales and
    the output channels' weight scales in fp32, plus the fp32 bias, cast
    to the layer's dtype.

Activations are quantized per row (the last axis), weights per output
channel, each with ``max(absmax, 1e-8) / 127``, rounded half to even and
clipped to +-127, as the JAX package does. No model, config or checkpoint
changes. A live model's weight is quantized once, at its first product
under the context, and its codes are kept (beside the weight, in a weak
map) until an in-place update bumps the weight's version; so a call
quantizes only its activations. While ``torch.export`` traces, nothing is
kept: an exported int8 graph quantizes its weights at each call.

What it covers, checked against the JAX package's ``nn.Dense`` both ways
(each ``models/layers.py:dense`` caller is a Dense there, and each Dense
there has a caller here):

- ``models/layers.py`` ``dense``: the attention's fused in-projection and
  out-projection and the MLP's ``c_fc``/``c_proj`` (JAX layers.py:72, 92,
  114, 121); the text tower's ``text_projection`` (text.py:109);
  AttentionPool2d's ``q_proj``/``k_proj``/``v_proj``/``c_proj`` and the
  ResNet's ``fc`` (resnet.py:263, 348, 355); FILIP's and DeFILIP's
  ``image_mapping``/``text_mapping`` and ``text_label_predictor``
  (filip_model.py:101-104, defilip_model.py:84-95, declip_model.py:95);
  the SSL and SLIP heads (heads.py, ssl_builders.py);
- ``models/vit.py`` ``PatchEmbed``: a plain ``x @ kernel`` here, an
  ``nn.Dense(use_bias=False)`` there (vit.py:78).

Not covered, as there: the ViT's ``proj`` (a ``self.param`` matmul,
vit.py:127), the attention's score and value products, convolutions and
LayerNorm. A product is routed only where both the input's last dim and
the output width reach ``min_dim`` (quant.py:110-118 there).

The int32 product is ``torch._int_mm``, on the card and on the CPU alike:
int8 operands summed in int32, exact on both, so the two agree bit for
bit on the accumulator (the JAX package leaves this product to XLA's
``dot_general``; it has no Pallas kernel, and the port writes none). On
CUDA ``_int_mm`` takes more than 16 rows, an inner and outer width
divisible by 8 and (cuBLASLt) a column-major second operand, as measured
on an H100 (chip_smoke.py phase 14, ``int_mm_probe``): the rows are
padded by 16 zero rows, whatever their count, so that an exported graph
holds no branch on the batch size, and the widths by zeros up to a
multiple of 8, which changes no sum.

The context is a ``contextvars.ContextVar``: it holds on the thread (and
in the context) that enters it, so a serving host enters it in the
thread that runs the towers. Under ``torch.export`` the quantized products
are what gets recorded.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["int8_inference", "int8_dense", "quantize_colwise",
           "quantize_rowwise", "routes"]

# min_dim of the innermost int8_inference, None outside one
_MIN_DIM: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "declip_tpu_torch_int8_min_dim", default=None)
_PAD_ROWS = 16


def _quantize(x: torch.Tensor, dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last axis) int8 -> ``(q, scale[..., 1])``."""
    return _quantize(x, -1)


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an ``[in, out]`` kernel (the
    JAX package's layout) -> ``(q, scale[1, out])``."""
    return _quantize(w, 0)


def _pad_to_8(n: int) -> int:
    return -n % 8


def _weight_operand(qw: torch.Tensor) -> torch.Tensor:
    """``[N, K] int8`` -> ``_int_mm``'s second operand, ``[K', N']`` (the
    widths padded to multiples of 8) in column-major: the transpose of a
    contiguous padded ``qw``. cuBLASLt refuses the int8 product with a
    row-major one."""
    n, k = qw.shape
    return F.pad(qw, (0, _pad_to_8(k), 0, _pad_to_8(n))).t()


def _int_mm(qx: torch.Tensor, w_op: torch.Tensor, n: int) -> torch.Tensor:
    """``[M, K] int8`` times a :func:`_weight_operand` -> ``[M, n]`` int32,
    padded as the module docstring says."""
    m, k = qx.shape
    qx = F.pad(qx, (0, w_op.shape[0] - k, 0, _PAD_ROWS))
    return torch._int_mm(qx, w_op)[:m, :n]


def _int32_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``[M, K] int8`` times the transpose of ``[N, K] int8`` -> ``[M, N]``
    int32 through ``torch._int_mm``."""
    return _int_mm(qx, _weight_operand(qw), qw.shape[0])


# weight -> (its version, _int_mm operand, scales [1, out])
_CODES = WeakIdKeyDictionary()


def _weight_codes(weight: torch.Tensor,
                  matrix: Optional[Callable[[torch.Tensor], torch.Tensor]]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 operand and per-output-channel scales of ``weight`` (an
    ``[out, in]`` matrix, or what ``matrix`` maps to one): kept per weight
    and version outside tracing (see the module docstring)."""
    keep = not (torch.compiler.is_compiling() or weight.is_inference())
    if keep:
        hit = _CODES.get(weight)
        if hit is not None and hit[0] == weight._version:
            return hit[1], hit[2]
    w = weight if matrix is None else matrix(weight)
    # quantize_colwise of the [in, out] kernel, computed on [out, in]:
    # the same elements, scales and codes, in the layout _int_mm takes
    qw, sw = _quantize(w.float(), -1)
    codes = _weight_operand(qw), sw.t()
    if keep:
        _CODES[weight] = (weight._version, *codes)
    return codes


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype,
               matrix: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> torch.Tensor:
    """``nn.Dense`` through int8 (quant.py:61-82 there): ``x [..., in]``,
    ``weight [out, in]`` (torch's layout) or a tensor that ``matrix`` maps
    to one (the weight is the key its codes are kept under), fp32 bias ->
    ``[..., out]`` in ``dtype``."""
    qx, sx = quantize_rowwise(x.float())
    w_op, sw = _weight_codes(weight, matrix)
    n = sw.shape[1]
    acc = _int_mm(qx.reshape(-1, qx.shape[-1]), w_op, n)
    y = acc.reshape(*x.shape[:-1], n).float() * sx * sw
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def routes(x: torch.Tensor, d_out: int) -> bool:
    """Whether a Dense of input ``x`` and output width ``d_out`` runs in
    int8 here: inside :func:`int8_inference`, both widths at least its
    ``min_dim``."""
    min_dim = _MIN_DIM.get()
    return (min_dim is not None and x.dim() >= 1
            and x.shape[-1] >= min_dim and d_out >= min_dim)


@contextlib.contextmanager
def int8_inference(min_dim: int = 64) -> Iterator[None]:
    """Route every Dense product under this context through int8 (see the
    module docstring). For inference: it has no gradient to speak of
    (``round`` has none)."""
    token = _MIN_DIM.set(int(min_dim))
    try:
        yield
    finally:
        _MIN_DIM.reset(token)
