"""The kernels on the card, at the edges chip_smoke.py does not reach. The
attention kernels: lengths at the edges of the 16-row mma tiles and of the
64-row and 128-row block tiles (L = 1, 15, 16, 17, 50, 63, 64, 65, 77, 127,
128, 129, 130, 200, 577), causal masks across three or more 64-row tiles,
both head dims, both dtypes, and B*H of 6 and of 1; K1 (the forward) and
K2 (the backward), each against its plain version; K1's fp32 route also
at scores up to 30, and the fp32 limit against plain TF32, which it must
fail. The late-interaction
kernels K3, K4 and K5: odd N1, N2 and GB across their 64-row and 128-token
tiles, both dtypes, exact ties, NaN features, and the inputs they refuse;
K3's winner mask bit for bit against its plain version; K3 at the dense
zero-shot eval's shape (B=128, N1=49 against 1000 classes of N2=77) and at
B=7 against 1001; in bf16 (K3 on
the tensor cores) N2 = 16, whose maxima are taken in registers, other
widths of whole n8 tiles (N2 = 8, 32, 64) through the shared-memory
epilogue, D a multiple of 8 and not of 16, identical key tokens tying on
continuous inputs, and misaligned views refused.

Needs a CUDA card and nvcc; marked ``cuda`` and skipped elsewhere. On the
card (the repository's conftest imports JAX, which the card's machine need
not have)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Tolerances and the rule that applies them are chip_smoke.py's
(``TOLERANCE``, ``BWD_TOLERANCE``, ``LI_TOLERANCE``, ``_within``), whose
comments give their reasons. K3-K5's inputs are small multiples of 1/64,
so that every similarity is exact in fp32 and the kernels and the plain
versions find the same max winners (with continuous inputs a near tie may
go either way when the two sum in other orders).
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import importlib.util
import pathlib

import pytest
import torch

from declip_tpu_torch.ops import filip_late_interaction as fli
from declip_tpu_torch.ops.flash_attention import (
    _forward_kernel,
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
)

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
LENGTHS = [1, 15, 16, 17, 50, 63, 64, 65, 77, 127, 128, 129, 130, 200, 577]
# (B, H): several heads, and one (the grid's smallest)
BATCH_HEADS = [(3, 2), (1, 1)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(card, length, dh, dtype, seed, n=3, bh=(3, 2)):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(*bh, length, dh, generator=g, device=card).to(dtype)
            for _ in range(n)]


def _tolerance(table, dtype):
    return table[str(dtype).replace("torch.", "")]


def _assert_within(got, want, table, name=""):
    tol = _tolerance(table, got.dtype)
    ok, err, share = smoke._within(got, want, *tol)
    assert ok, (f"{name}: max abs err {err:.3g}, {share:.0%} of its limit "
                f"under (rtol, atol, atol share) {tol}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("bh", BATCH_HEADS, ids=["bh6", "bh1"])
def test_kernel_matches_plain(card, bh, length, causal, dh, dtype):
    q, k, v = _qkv(card, length, dh, dtype, length * 7 + dh + causal, bh=bh)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_within(got, want, smoke.TOLERANCE)


# the serving path's two attention shapes, (H, L, causal), at Dh=64
SERVING_SHAPES = [(12, 50, False), (8, 77, True)]


@pytest.mark.parametrize("heads,length,causal", SERVING_SHAPES,
                         ids=["image", "text"])
def test_kernel_matches_plain_large_scores(card, heads, length, causal):
    """fp32 with q and k scaled so that the largest |score| is 30: nearly
    one-hot rows, where an error in a score is an error of the same size
    in its probability."""
    q, k, v = _qkv(card, length, 64, torch.float32, 40 + length,
                   bh=(2, heads))
    scale = 64 ** -0.5
    s_max = (torch.matmul(q, k.transpose(-1, -2)) * scale).abs().max()
    q, k = (x * (30.0 / s_max.item()) ** 0.5 for x in (q, k))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    assert 29.9 < s.abs().max().item() < 30.1
    got = flash_attention(q, k, v, causal=causal, scale=scale)
    want = attention_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    _assert_within(got, want, smoke.TOLERANCE)


@pytest.mark.parametrize("heads,length,causal", SERVING_SHAPES,
                         ids=["image", "text"])
def test_fp32_limit_fails_plain_tf32(card, heads, length, causal):
    """At the serving shapes, the plain version on inputs rounded to TF32
    misses TOLERANCE["float32"]: the limit the fp32 route is held to would
    fail a kernel that took its fp32 products in TF32 alone."""
    q, k, v = _qkv(card, length, 64, torch.float32, 60 + length,
                   bh=(8, heads))
    _, share = smoke.tf32_plain_check(q, k, v, causal, 64 ** -0.5)
    assert share > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("bh", BATCH_HEADS, ids=["bh6", "bh1"])
def test_backward_kernel_matches_plain(card, bh, length, causal, dh, dtype):
    """Autograd through flash_attention on the card: K1 keeps the row
    log-sum-exp, K2 gives dq, dk, dv; each against attention_bwd_plain."""
    q, k, v, do = _qkv(card, length, dh, dtype, length * 11 + dh + causal, 4,
                       bh=bh)
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
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape, name
        _assert_within(g, w, smoke.BWD_TOLERANCE, name)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_lse_matches_logsumexp(card, causal):
    """K1's log-sum-exp output, the row statistic K2 rebuilds P from."""
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


def test_bf16_kernels_refuse_misaligned_tensors(card):
    """The bf16 kernels read 16 bytes at a time: a contiguous bf16 view one
    element into its storage raises, forward and backward, and the card
    stays usable."""
    q, k, v, do = _qkv(card, 16, 64, torch.bfloat16, 4, 4)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=card)
    shifted = flat[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(shifted, k, v)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(q, k, shifted)
    o, lse = _forward_kernel(q, k, v, False, 64 ** -0.5, with_lse=True)
    shifted.copy_(o)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_bwd(q, k, v, shifted, lse, do)
    shifted.copy_(do)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention_bwd(q, k, v, o, lse, shifted)
    # the refusals left the context whole: the kernels still run
    got = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    _assert_within(got[0], attention_bwd_plain(q, k, v, do)[0],
                   smoke.BWD_TOLERANCE, "dq")


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


def _grid(card, shape, seed, dtype):
    """Multiples of 1/64 with numerators in [-12, 12]: exact in bf16, and
    every product and sum of D <= 256 of them exact in fp32."""
    g = torch.Generator(device=card).manual_seed(seed)
    return (torch.randint(-12, 13, shape, generator=g, device=card)
            .float() / 64).to(dtype)


def _li_check(card, b, n1, gb, n2, d, dtype, seed, d2=None):
    d1 = _grid(card, (b, n1, d), seed, dtype)
    if d2 is None:
        d2 = _grid(card, (gb, n2, d), seed + 1, dtype)
    g = torch.randn(b, gb, generator=torch.Generator(device=card)
                    .manual_seed(seed + 2), device=card)
    (fwd_rtol, fwd_atol), (rtol, atol) = _tolerance(smoke.LI_TOLERANCE,
                                                    dtype)
    leaves = [d1.clone().requires_grad_(), d2.clone().requires_grad_()]
    before = (fli.late_interaction_fwd.launches,
              fli.late_interaction_bwd_d1.launches,
              fli.late_interaction_bwd_d2.launches)
    raw = fli._LateInteraction.apply(*leaves)
    dd1, dd2 = torch.autograd.grad(raw, leaves, g)
    torch.cuda.synchronize()
    assert (fli.late_interaction_fwd.launches,
            fli.late_interaction_bwd_d1.launches,
            fli.late_interaction_bwd_d2.launches) == \
        tuple(n + 1 for n in before)
    assert raw.dtype == torch.float32 and raw.shape == (b, gb)
    assert dd1.dtype == dd2.dtype == dtype
    torch.testing.assert_close(raw, fli.late_interaction_raw_plain(d1, d2),
                               rtol=fwd_rtol, atol=fwd_atol)
    want1, want2 = fli.late_interaction_bwd_plain(d1, d2, g)
    torch.testing.assert_close(dd1.float(), want1.float(), rtol=rtol,
                               atol=atol, msg="dd1")
    torch.testing.assert_close(dd2.float(), want2.float(), rtol=rtol,
                               atol=atol, msg="dd2")
    # each kernel alone against its plain version on the same winners
    _, winners = fli.late_interaction_fwd(d1, d2)
    assert torch.equal(winners, fli.late_interaction_winners_plain(d1, d2))
    torch.testing.assert_close(
        fli.late_interaction_bwd_d1(winners, d2, g).float(),
        fli.late_interaction_bwd_d1_plain(winners, d2, g).float(),
        rtol=rtol, atol=atol, msg="K4")
    torch.testing.assert_close(
        fli.late_interaction_bwd_d2(winners, d1, g, n2).float(),
        fli.late_interaction_bwd_d2_plain(winners, d1, g, n2).float(),
        rtol=rtol, atol=atol, msg="K5")
    return dd2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n1,gb,n2,d", [
    (3, 1, 1, 1, 8),        # one of everything
    (5, 13, 129, 3, 40),    # GB one past a key tile, D not a multiple of 32
    (2, 65, 7, 17, 64),     # N1 one past a row tile, 7 key items of 17
    (4, 33, 70, 65, 256),   # wide key items (N2 > 64), two d slices in K5
    (1, 200, 9, 128, 96),   # the largest N2, N1 across four row tiles
    (7, 77, 300, 16, 256),  # text queries, GB of three key tiles
    (3, 50, 41, 16, 200),   # D a multiple of 8, not 16; unaligned items
    (2, 70, 33, 8, 64),     # whole n8 tiles, shared-memory epilogue
    (4, 20, 21, 32, 128),   # likewise, one mask word an item
    (2, 40, 9, 64, 96),     # likewise, two mask words an item
])
def test_late_interaction_kernels_match_plain(card, b, n1, gb, n2, d, dtype):
    _li_check(card, b, n1, gb, n2, d, dtype, seed=b * 1000 + n1 + gb + n2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_late_interaction_kernels_split_ties(card, dtype):
    """Duplicated key tokens tie exactly: K4 and K5 split the gradient
    evenly between them, as the plain versions (and jnp.max) do."""
    d2 = _grid(card, (40, 6, 64), 3, dtype)
    d2[:, 4] = d2[:, 1]
    d2[::3, 5] = d2[::3, 1]
    dd2 = _li_check(card, 6, 11, 40, 6, 64, dtype, seed=9, d2=d2)
    torch.testing.assert_close(dd2[:, 4], dd2[:, 1], rtol=0, atol=0)
    assert dd2[:, 1].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n1,gb,n2,d", [(16, 49, 64, 16, 256),
                                          (5, 30, 20, 17, 64)])
def test_late_interaction_identical_tokens_tie_on_unit_vectors(
        card, b, n1, gb, n2, d, dtype):
    """Key tokens that are copies of one another, on continuous unit
    vectors (no grid): their similarities are computed alike, so K3 sets
    their winner bits together, bit for bit, and K5 gives them one
    gradient."""
    d1, d2, g = smoke._li_inputs((b, n1, gb, n2, d), dtype, 77, grid=False)
    d2[:, 4] = d2[:, 1]
    d2[::2, 7] = d2[::2, 1]
    _, winners = fli.late_interaction_fwd(d1, d2)
    bits = ((winners[..., None] >> torch.arange(32, device=card)) & 1)
    bits = bits.reshape(*winners.shape[:2], -1)
    assert torch.equal(bits[..., 4], bits[..., 1])
    assert torch.equal(bits[:, ::2, 7], bits[:, ::2, 1])
    assert bits[..., 1].any() and bits[:, ::2, 7].any()
    dd2 = fli.late_interaction_bwd_d2(winners, d1, g, n2)
    torch.testing.assert_close(dd2[:, 4], dd2[:, 1], rtol=0, atol=0)


def test_late_interaction_refuses_misaligned_bf16(card):
    """K3's bf16 route copies rows 16 bytes at a time: a contiguous bf16
    view one element into its storage raises ValueError, directly and
    through the autograd route, and the card stays usable; fp32 has no such
    rule."""
    d1 = _grid(card, (2, 5, 64), 41, torch.bfloat16)
    d2 = _grid(card, (3, 16, 64), 42, torch.bfloat16)
    for i, x in enumerate((d1, d2)):
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=card)
        shifted = flat[1:].view(x.shape)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        shifted.copy_(x)
        args = (shifted, d2) if i == 0 else (d1, shifted)
        with pytest.raises(ValueError, match="16-byte boundary"):
            fli.late_interaction_fwd(*args)
        with pytest.raises(ValueError, match="16-byte boundary"):
            fli.late_interaction_logits_kernel(*args, torch.ones(()))
        flat32 = torch.zeros(x.numel() + 1, device=card)
        shifted32 = flat32[1:].view(x.shape)
        shifted32.copy_(x)
        args32 = ((shifted32, d2.float()) if i == 0
                  else (d1.float(), shifted32))
        torch.testing.assert_close(
            fli.late_interaction_fwd(*args32)[0],
            fli.late_interaction_raw_plain(d1, d2), rtol=1e-5, atol=1e-5)
    raw, winners = fli.late_interaction_fwd(d1, d2)
    torch.cuda.synchronize()
    assert torch.equal(winners, fli.late_interaction_winners_plain(d1, d2))
    torch.testing.assert_close(raw, fli.late_interaction_raw_plain(d1, d2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("where", ["key", "query"])
def test_late_interaction_kernels_propagate_nan(card, where, dtype):
    """A NaN feature wins its max, as in torch.amax and jnp.max, and its
    row's gradient weights all become NaN: the kernels give NaN exactly
    where the plain versions do, and their values elsewhere."""
    d1 = _grid(card, (5, 9, 64), 31, dtype)
    d2 = _grid(card, (12, 7, 64), 32, dtype)
    if where == "key":
        d2[4, 2, 10] = float("nan")
    else:
        d1[1, 3, 10] = float("nan")
    g = torch.randn(5, 12, generator=torch.Generator(device=card)
                    .manual_seed(33), device=card)
    (fwd_rtol, fwd_atol), (rtol, atol) = _tolerance(smoke.LI_TOLERANCE,
                                                    dtype)
    want1, want2 = fli.late_interaction_bwd_plain(d1, d2, g)
    raw, winners = fli.late_interaction_fwd(d1, d2)
    assert torch.equal(winners, fli.late_interaction_winners_plain(d1, d2))
    for got, want, tol in (
            (raw, fli.late_interaction_raw_plain(d1, d2),
             (fwd_rtol, fwd_atol)),
            (fli.late_interaction_bwd_d1(winners, d2, g), want1,
             (rtol, atol)),
            (fli.late_interaction_bwd_d2(winners, d1, g, d2.shape[1]),
             want2, (rtol, atol))):
        assert torch.isnan(want).any()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                                   atol=tol[1], equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", range(len(smoke.LI_CASES) + 1),
                         ids=[*("x".join(map(str, c))
                                for c in smoke.LI_CASES), "ties"])
def test_late_interaction_winners_match_plain(card, case, dtype):
    """K3's winner mask equals late_interaction_winners_plain bit for bit,
    on grid inputs (every similarity exact) at chip_smoke.py's LI_CASES and
    its ties case (two-way ties in every key item, three-way in half)."""
    ties = case == len(smoke.LI_CASES)
    shape = smoke.LI_TIES_CASE if ties else smoke.LI_CASES[case]
    d1, d2, _ = smoke._li_inputs(shape, dtype, 600 + case, grid=True)
    if ties:
        d2[:, 4] = d2[:, 1]
        d2[::2, 7] = d2[::2, 1]
    raw, winners = fli.late_interaction_fwd(d1, d2)
    want = fli.late_interaction_winners_plain(d1, d2)
    assert winners.dtype == torch.int32 and winners.shape == want.shape
    assert torch.equal(winners, want)
    if ties:
        counts = fli._winner_weights(want, torch.ones_like(raw),
                                     shape[3]).ne(0).sum(-1)
        assert (counts >= 2).any() and (counts >= 3).any()


@pytest.mark.parametrize("b,gb", [(128, 1000), (7, 1001)],
                         ids=["imagenet", "awkward"])
def test_late_interaction_forward_at_the_dense_eval_shape(card, b, gb):
    """K3 at the FILIP family's zero-shot eval shape: B image queries of
    N1=49 tokens against GB class keys of N2=77 tokens (three mask words an
    item, GB no multiple of the key tile), D=256, in bf16 (the recipes'
    precision, which gives both sides bf16): the raw logits against the
    plain version and the winners bit for bit on grid inputs; then on unit
    vectors, the class keys a slice of a chunked concatenation as the
    solver builds them, through ``late_interaction_logits_kernel`` under
    ``no_grad`` as the eval calls it, one launch, against the plain
    version."""
    d1 = _grid(card, (b, 49, 256), b + gb, torch.bfloat16)
    d2 = _grid(card, (gb, 77, 256), b + gb + 1, torch.bfloat16)
    (fwd_rtol, fwd_atol), _ = _tolerance(smoke.LI_TOLERANCE, torch.bfloat16)
    raw, winners = fli.late_interaction_fwd(d1, d2)
    torch.testing.assert_close(raw, fli.late_interaction_raw_plain(d1, d2),
                               rtol=fwd_rtol, atol=fwd_atol)
    assert torch.equal(winners, fli.late_interaction_winners_plain(d1, d2))
    del winners
    g = torch.Generator(device=card).manual_seed(b * gb)
    q = torch.nn.functional.normalize(torch.randn(
        b, 49, 256, generator=g, device=card), dim=-1).bfloat16()
    chunks = [torch.nn.functional.normalize(torch.randn(
        512, 77, 256, generator=g, device=card), dim=-1).bfloat16()
        for _ in range(2)]
    keys = torch.cat(chunks)[:gb]
    before = fli.late_interaction_fwd.launches
    with torch.no_grad():
        logits = fli.late_interaction_logits_kernel(
            q, keys, torch.ones((), device=card))
    assert fli.late_interaction_fwd.launches == before + 1
    torch.testing.assert_close(logits,
                               fli.late_interaction_raw_plain(q, keys),
                               rtol=1e-5, atol=1e-5)


def test_late_interaction_forward_unit_vectors(card):
    """Continuous unit-vector inputs, as the training path gives them: the
    forward (a max's value does not depend on which near-tie wins)."""
    g = torch.Generator(device=card).manual_seed(21)
    d1 = torch.nn.functional.normalize(
        torch.randn(9, 49, 256, generator=g, device=card), dim=-1)
    d2 = torch.nn.functional.normalize(
        torch.randn(131, 16, 256, generator=g, device=card), dim=-1)
    torch.testing.assert_close(fli.late_interaction_fwd(d1, d2)[0],
                               fli.late_interaction_raw_plain(d1, d2),
                               rtol=1e-5, atol=1e-5)


def test_late_interaction_kernels_refuse(card):
    """What the kernels do not take raises; nothing falls back to the plain
    version."""
    d1, d2 = torch.zeros(2, 5, 64, device=card), torch.zeros(3, 4, 64,
                                                            device=card)
    g = torch.zeros(2, 3, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fli.late_interaction_fwd(d1.half(), d2.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fli.late_interaction_fwd(d1, d2.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fli.late_interaction_fwd(d1.transpose(0, 1).contiguous()
                                 .transpose(0, 1), d2)
    with pytest.raises(ValueError, match="at most 128 key tokens"):
        fli.late_interaction_fwd(d1, torch.zeros(3, 129, 64, device=card))
    with pytest.raises(ValueError, match="feature dim of at most 256"):
        fli.late_interaction_fwd(torch.zeros(2, 5, 264, device=card),
                                 torch.zeros(3, 4, 264, device=card))
    w = torch.zeros(10, 3, 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="fp32"):
        fli.late_interaction_bwd_d1(w, d2, g.double())
    with pytest.raises(ValueError, match="fp32"):
        fli.late_interaction_bwd_d2(w, d1, g[:, :2], 4)
    # the winners: K3's int32 [B*N1, GB, ceil(N2/32)], contiguous, on the
    # features' device
    for bad in (w.long(), w[:, :2], w.repeat(1, 1, 2), w[:5],
                w.transpose(0, 1).contiguous().transpose(0, 1), w.cpu()):
        with pytest.raises(ValueError, match="winners"):
            fli.late_interaction_bwd_d1(bad, d2, g)
        with pytest.raises(ValueError, match="winners"):
            fli.late_interaction_bwd_d2(bad, d1, g, 4)
    with pytest.raises(ValueError, match="winners"):  # N2 = 33: two words
        fli.late_interaction_bwd_d2(w, d1, g, 33)
    with pytest.raises(ValueError, match="at most 128 key tokens"):
        fli.late_interaction_bwd_d2(w, d1, g, 129)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fli.late_interaction_bwd_d1(w, d2.cpu(), g)
    # the autograd route refuses the same way, forward and backward
    with pytest.raises(ValueError, match="at most 128 key tokens"):
        fli.late_interaction_logits_kernel(
            d1, torch.zeros(3, 200, 64, device=card), torch.ones(()))


def test_resnet_fp32_on_the_card_matches_the_cpu(card):
    """The port's ModifiedResNet in fp32 on the card (cuDNN convs and
    BatchNorm, with TF32 off, as the fp32 checks of chip_smoke.py run it)
    against the same weights on the CPU, in training mode: the output, the
    input gradient and the committed running statistics. cuDNN's fp32
    convs default to TF32 on Hopper, which would miss these limits."""
    from declip_tpu_torch.models.layers import BatchNorm, commit_bn_stats
    from declip_tpu_torch.models.resnet import ModifiedResNet

    g = torch.Generator().manual_seed(1)
    x0 = (torch.randn(8, 64, 64, 3, generator=g)
          + torch.randn(8, 1, 1, 3, generator=g))
    r = torch.randn(8, 64, generator=g)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = {}
        for dev in (torch.device("cpu"), card):
            model = ModifiedResNet(layers=(1, 1, 1, 1), embed_dim=64,
                                   heads=4, input_resolution=64, width=16)
            model.init_weights(torch.Generator().manual_seed(0))
            model.to(dev).train()
            x = x0.to(dev).detach().requires_grad_(True)
            y = model(x)
            (y * r.to(dev)).sum().backward()
            commit_bn_stats(model)
            got[dev.type] = (y.detach().cpu(), x.grad.cpu(), [
                t.cpu() for m in model.modules() if isinstance(m, BatchNorm)
                for t in (m.running_mean, m.running_var)])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    (y_c, dx_c, st_c), (y_g, dx_g, st_g) = got["cpu"], got["cuda"]
    torch.testing.assert_close(y_g, y_c, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-4,
                               atol=1e-5 * dx_c.abs().max().item())
    for a, b in zip(st_g, st_c):
        assert (a - b).norm() <= 1e-5 * b.norm()


def test_augment_views_on_the_card_matches_the_cpu(card):
    """The on-device photometrics (data/device_aug.py; plain PyTorch, no
    hand-written kernel) on the card against the CPU on the same drawn
    parameters: two MOCOV2 views from the card's generators, the draws
    replayed from the same (seed, step, view) keys and applied on the CPU; fp32
    within 1e-5 (TF32 off for the hue's 3x3 product), and the bf16 output
    within one bf16 ulp of the fp32 result cast (the card's own: near
    zero, the CPU's and the card's fp32 results may take opposite signs
    within their 1e-5)."""
    from declip_tpu_torch.data import device_aug

    g = torch.Generator().manual_seed(2)
    crops = torch.randint(0, 256, (16, 64, 64, 6), generator=g,
                          dtype=torch.uint8)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = device_aug.augment_views(crops.to(card), views=2, seed=4,
                                       step=9)
        half = device_aug.augment_views(crops.to(card), views=2, seed=4,
                                        step=9, dtype=torch.bfloat16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want = torch.cat([
        device_aug.photometric_apply(
            crops[..., 3 * v:3 * v + 3],
            {k: t.cpu() for k, t in device_aug.photometric_params(
                device_aug.view_generator(4, 9, v, card),
                crops.shape[0]).items()})
        for v in range(2)], dim=-1)
    assert got.dtype == torch.float32 and got.shape == crops.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    cast = got.to(torch.bfloat16).float().cpu()
    ulp = torch.exp2(torch.floor(torch.log2(
        cast.abs().clamp_min(2.0 ** -100))) - 7)
    assert half.dtype == torch.bfloat16
    assert bool(((half.float().cpu() - cast).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_registered_ops_equal_their_launches(card, dtype):
    """Each ``declip_tpu_torch::`` operator on CUDA tensors gives what its
    launch gives, bit for bit, and counts one launch: K1 with and without
    its log-sum-exp, K2, K3, K4 and K5 (the kernels are deterministic)."""
    ops = torch.ops.declip_tpu_torch
    q, k, v, do = _qkv(card, 77, 64, dtype, 5, n=4, bh=(3, 8))
    scale = 64 ** -0.5
    for with_lse in (False, True):
        want = _forward_kernel(q, k, v, True, scale, with_lse)
        before = flash_attention.launches
        got = ops.flash_attn_fwd(q, k, v, True, scale, with_lse)
        assert flash_attention.launches == before + 1
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1]) if with_lse \
            else got[1].numel() == 0
    o, lse = want
    before = flash_attention_bwd.launches
    got = ops.flash_attn_bwd(q, k, v, o, lse, do, True, scale)
    assert flash_attention_bwd.launches == before + 1
    for a, b in zip(got, flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True, scale=scale)):
        assert torch.equal(a, b)

    g = torch.Generator(device=card).manual_seed(6)
    d1 = (torch.randint(-64, 65, (5, 49, 64), generator=g, device=card)
          / 64).to(dtype)
    d2 = (torch.randint(-64, 65, (9, 77, 64), generator=g, device=card)
          / 64).to(dtype)
    grad = torch.randn(5, 9, generator=g, device=card)
    counts = (fli.late_interaction_fwd.launches,
              fli.late_interaction_bwd_d1.launches,
              fli.late_interaction_bwd_d2.launches)
    raw, winners = ops.late_interaction_fwd(d1, d2)
    dd1 = ops.late_interaction_bwd_d1(winners, d2, grad)
    dd2 = ops.late_interaction_bwd_d2(winners, d1, grad, 77)
    assert (fli.late_interaction_fwd.launches,
            fli.late_interaction_bwd_d1.launches,
            fli.late_interaction_bwd_d2.launches) == tuple(
                c + 1 for c in counts)
    want_raw, want_winners = fli.late_interaction_fwd(d1, d2)
    assert torch.equal(raw, want_raw) and torch.equal(winners, want_winners)
    assert torch.equal(dd1, fli.late_interaction_bwd_d1(winners, d2, grad))
    assert torch.equal(dd2, fli.late_interaction_bwd_d2(winners, d1, grad,
                                                        77))


def test_exported_tower_keeps_k1_on_the_card(card, tmp_path):
    """``torch.export`` of a one-layer ViT tower on the card keeps K1's
    operator as a node of the graph, and running the saved and loaded
    artifact launches K1 once a call, on any batch of the symbolic dim."""
    from declip_tpu_torch.models.vit import VisualTransformer

    tower = VisualTransformer(input_resolution=64, patch_size=32, width=128,
                              layers=1, heads=2, embed_dim=32)
    tower.init_weights(torch.Generator().manual_seed(0))
    tower = tower.to(card).eval()
    x = torch.randn(2, 64, 64, 3, device=card)
    with torch.no_grad():
        program = torch.export.export(
            tower, (x,),
            dynamic_shapes={"x": {0: torch.export.Dim("batch", min=1)}})
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert torch.ops.declip_tpu_torch.flash_attn_fwd.default in targets
    torch.export.save(program, tmp_path / "tower.pt2")
    module = torch.export.load(tmp_path / "tower.pt2").module()
    for b in (1, 3):
        xb = torch.randn(b, 64, 64, 3, device=card)
        before = flash_attention.launches
        with torch.no_grad():
            got = module(xb)
            want = tower(xb)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 2
        assert torch.equal(got, want)
