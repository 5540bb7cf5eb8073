"""The port's attention gradient (K2's plain version and the autograd
Function around K1/K2) against the JAX package's Pallas backward kernel.

On CPU tensors ``flash_attention`` runs its plain forward and
``attention_bwd_plain``; both are held against ``jax.vjp`` through the JAX
``flash_attention(..., interpret=True)``, whose backward is ``_bwd_kernel``
run in interpret mode, on the same numpy inputs.

Tolerances: fp32 rtol 1e-4 / atol 1e-6 (the two sides differ in summation
order only; max abs diff measured at 1.4e-6 on gradients up to 5 in
magnitude); bf16 rtol/atol 2e-2 (P and dS are rounded to bf16 on both
sides, and a value on a rounding boundary may round the other way after an
fp32 sum in another order).
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.ops.flash_attention import flash_attention as jax_flash

from declip_tpu_torch.models.layers import Transformer
from declip_tpu_torch.ops.attention import dot_product_attention
from declip_tpu_torch.ops.flash_attention import (
    attention_bwd_plain,
    flash_attention,
    flash_attention_bwd,
)

RTOL, ATOL = 1e-4, 1e-6


def _inputs(seed, l, dh, b=2, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, l, dh)).astype(np.float32)
            for _ in range(4)]  # q, k, v, do


def _jax_grads(q, k, v, do, causal, dtype=jnp.float32):
    """(dq, dk, dv) of the JAX Pallas kernel (interpret mode) as fp32."""
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, causal=causal, interpret=True),
        *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, dtype))]


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [7, 16, 50, 77])
def test_backward_matches_jax_kernel(l, causal, dh):
    """attention_bwd_plain, and the gradients autograd takes through
    flash_attention (the Function) and through the dispatch, all equal the
    Pallas _bwd_kernel's."""
    q, k, v, do = _inputs(l * 10 + dh + causal, l, dh)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    plain = attention_bwd_plain(tq, tk, tv, tdo, causal)
    for got, ref in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(*leaves, causal=causal)
    autograd = torch.autograd.grad(out, leaves, tdo)
    assert (flash_attention.launches,
            flash_attention_bwd.launches) == before  # CPU: no kernel
    for got, ref in zip(autograd, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = dot_product_attention(*leaves, causal=causal, impl="auto")
    for got, ref in zip(torch.autograd.grad(out, leaves, tdo), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_impl_gradients_match(causal):
    """impl 'xla' (plain attention under torch autograd, no Function) gives
    the same gradients as the Function."""
    q, k, v, do = map(torch.from_numpy, _inputs(11, 20, 32))
    grads = []
    for impl in ("auto", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = dot_product_attention(*leaves, causal=causal, impl=impl)
        grads.append(torch.autograd.grad(out, leaves, do))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_matches_jax_kernel(causal):
    q, k, v, do = _inputs(21 + causal, 50, 64)
    want = _jax_grads(q, k, v, do, causal, jnp.bfloat16)
    got = attention_bwd_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)),
        causal=causal)
    for g, ref in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=2e-2,
                                   atol=2e-2)


def test_checkpoint_gives_the_same_gradients():
    """checkpoint=True (torch.utils.checkpoint per block, recomputing the
    attention forward in the backward) gives the same gradients as a plain
    backward."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 9, 64)).astype(np.float32))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        tower = Transformer(64, 2, 2, causal=True, checkpoint=remat)
        tower.init_weights(torch.Generator().manual_seed(1))
        xin = x.clone().requires_grad_()
        loss = tower(xin).square().sum()
        grads.append(torch.autograd.grad(loss, [xin, *tower.parameters()]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
