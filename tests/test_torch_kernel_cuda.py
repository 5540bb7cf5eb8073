"""The attention kernels on the card, at the edges chip_smoke.py does not
reach: ragged query and key tiles (L = 1, 63, 64, 65, 130, 200), causal masks
across three or more 64-row tiles, both head dims and both dtypes; K1 (the
forward) and K2 (the backward), each against its plain version.

Needs a CUDA card and nvcc; marked ``cuda`` and skipped elsewhere. On the
card (the repository's conftest imports JAX, which the card's machine need
not have)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Tolerances as in chip_smoke.py. K1: fp32 differs from the plain version in
summation order only; bf16 by one bf16 rounding of P and of O. K2: fp32 by
summation order over three chained contractions and by its row term taken
from O instead of P (equal in exact arithmetic), 1e-4; bf16 by a bf16
rounding of P, dS and O, 2e-2.
"""

import pytest
import torch

from declip_tpu_torch.ops.flash_attention import (
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
)

pytestmark = pytest.mark.cuda

TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
BWD_TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
LENGTHS = [1, 63, 64, 65, 130, 200]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(card, length, dh, dtype, seed, n=3):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(3, 2, length, dh, generator=g, device=card).to(dtype)
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_kernel_matches_plain(card, length, causal, dh, dtype):
    q, k, v = _qkv(card, length, dh, dtype, length * 7 + dh + causal)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = TOLERANCE[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_backward_kernel_matches_plain(card, length, causal, dh, dtype):
    """Autograd through flash_attention on the card: K1 keeps the row
    log-sum-exp, K2 gives dq, dk, dv; each against attention_bwd_plain."""
    q, k, v, do = _qkv(card, length, dh, dtype, length * 11 + dh + causal, 4)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(*leaves, causal=causal)
    # merge_heads hands the backward a transposed, non-contiguous gradient
    do_strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(out, leaves, do_strided)
    want = attention_bwd_plain(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    rtol, atol = BWD_TOLERANCE[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_lse_matches_logsumexp(card, causal):
    """K1's log-sum-exp output, the row statistic K2 rebuilds P from."""
    from declip_tpu_torch.ops.flash_attention import _forward_kernel

    q, k, v = _qkv(card, 130, 64, torch.float32, 5)
    scale = 64 ** -0.5
    _, lse = _forward_kernel(q, k, v, causal, scale, with_lse=True)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones(130, 130, dtype=torch.bool,
                                      device=card).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_checkpoint_reruns_the_forward_kernel(card, dtype):
    """checkpoint=True recomputes each block in the backward, K1 included:
    two K1 calls and one K2 call per layer, and the same gradients."""
    from declip_tpu_torch.models.layers import Transformer

    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(4, 77, 64, generator=g, device=card)
    grads, calls = [], []
    for remat in (False, True):
        tower = Transformer(64, 3, 2, causal=True, dtype=dtype,
                            checkpoint=remat)
        tower.init_weights(torch.Generator().manual_seed(1))
        tower.to(card)
        xin = x.clone().requires_grad_()
        before = (flash_attention.launches, flash_attention_bwd.launches)
        loss = tower(xin).float().square().sum()
        grads.append(torch.autograd.grad(loss, [xin, *tower.parameters()]))
        calls.append((flash_attention.launches - before[0],
                      flash_attention_bwd.launches - before[1]))
    assert calls == [(3, 3), (6, 3)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_raises_instead_of_falling_back(card):
    q = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, q, q)
    # tensors that require grad go through the backward kernel
    q = torch.zeros(1, 2, 8, 64, device=card, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


def test_backward_kernel_refusals(card):
    q, k, v, do = _qkv(card, 16, 64, torch.float32, 3, 4)
    o, lse = (flash_attention(q, k, v),
              torch.zeros(3, 2, 16, device=card))
    with pytest.raises(ValueError, match="head dim"):
        t = torch.zeros(3, 2, 16, 48, device=card)
        flash_attention_bwd(t, t, t, t, lse, t)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t = q.half()
        flash_attention_bwd(t, t, t, t, lse, t)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention_bwd(*(x.cpu() for x in (q, k, v, o, lse, do)))
    with pytest.raises(ValueError, match="do must match"):
        flash_attention_bwd(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError, match="contiguous do"):
        flash_attention_bwd(q, k, v, o, lse, do.transpose(2, 3).contiguous()
                            .transpose(2, 3))
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd(q, k, v, o, lse.double(), do)
