"""The port's attention (declip_tpu_torch.ops) against the JAX package's.

On CPU tensors the port's ``flash_attention`` runs its plain version; it is
held against the JAX Pallas kernel in interpret mode and against the JAX
XLA path, on the same numpy inputs, in fp32. Tolerance rtol 2e-5 / atol
2e-6: the two sides differ only in summation order (max abs diff measured
at about 5e-7 at L=77 causal).
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.ops.attention import _xla_attention
from declip_tpu.ops.attention import merge_heads as jax_merge_heads
from declip_tpu.ops.attention import split_heads as jax_split_heads
from declip_tpu.ops.flash_attention import flash_attention as jax_flash

from declip_tpu_torch.ops.attention import (
    dot_product_attention,
    merge_heads,
    split_heads,
)
from declip_tpu_torch.ops.flash_attention import attention_plain, flash_attention

RTOL, ATOL = 2e-5, 2e-6


def _qkv(seed, b=2, h=2, l=7, dh=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, l, dh)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [7, 16, 50, 77])
def test_flash_attention_matches_jax(l, causal, dh):
    q, k, v = _qkv(l * 10 + dh + causal, l=l, dh=dh)
    scale = dh ** -0.5
    pallas = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, interpret=True))
    xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), causal,
                                    scale))
    before = flash_attention.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          causal=causal).numpy()
    assert flash_attention.launches == before  # CPU: plain version, no kernel
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_dispatch_matches_jax_xla(impl):
    """Every impl gives the same numbers on CPU; 'xla' is the plain path."""
    q, k, v = _qkv(3, l=12)
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), True,
                                     0.25))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, scale=0.25, impl=impl).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cross_attention_takes_plain_path():
    """Lq != Lk (the pooled-query form) is the plain path's, as in JAX."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 2, 1, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 9, 32)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), False,
                                     32 ** -0.5))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_split_merge_heads_match_jax():
    x = np.random.default_rng(1).normal(size=(2, 5, 12)).astype(np.float32)
    s = split_heads(torch.from_numpy(x), 3)
    assert s.is_contiguous()
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jax_split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(
        merge_heads(s).numpy(),
        np.asarray(jax_merge_heads(jax_split_heads(jnp.asarray(x), 3))))
    np.testing.assert_array_equal(merge_heads(s).numpy(), x)


def test_plain_bf16_rounds_p_like_the_tpu_kernel():
    """bf16 operands: fp32 scores and softmax, P cast to bf16 before P.V —
    the Pallas kernel's arithmetic, compared in fp32 after casting (one bf16
    rounding of P and of O: atol/rtol 2e-2)."""
    q, k, v = _qkv(7, l=16, dh=64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=True,
                                interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_plain(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_kernel_refuses_what_it_does_not_take():
    """The CUDA path's checks run before any launch (no card needed)."""
    from declip_tpu_torch.ops.flash_attention import _check_kernel_inputs

    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="head dim"):
        _check_kernel_inputs(*(torch.zeros(1, 2, 8, 48),) * 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _check_kernel_inputs(*(q.half(),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 64).transpose(1, 2)
        _check_kernel_inputs(t, t, t)
    with pytest.raises(ValueError, match="self-attention"):
        _check_kernel_inputs(q, torch.zeros(1, 2, 9, 64), q)
    # tensors that require grad are taken: the backward kernel exists
    _check_kernel_inputs(q.clone().requires_grad_(), q, q)
    with pytest.raises(ValueError, match="attn impl"):
        dot_product_attention(q, q, q, impl="cudnn")
