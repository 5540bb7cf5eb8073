"""The port's FILIP ops against the JAX package's, on the CPU: the late
interaction (the plain versions of K3, K4 and K5 behind the port's kernel
route, and the chunked ``impl: xla`` path) against JAX's chunked
``late_interaction_logits`` and its ``jax.grad``; the dispatch; MLM masking's
helpers (``compact_mlm``, ``mlm_loss``) and top-k token selection.

Inputs are unit vectors made with a seeded numpy generator, as in
tests/test_filip_pallas.py, whose shapes these are. Tolerances as there:
the forward rtol/atol 1e-5 (fp32, summation order), the gradients rtol 2e-4,
atol 2e-5 (fp32, summation order over the winners' contractions); bf16
inputs against fp32 at 2e-2 (the inputs' rounding).
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.losses import mlm_loss as jax_mlm_loss
from declip_tpu.models.clip_model import compact_mlm as jax_compact_mlm
from declip_tpu.models.filip_model import topk_token_select as jax_topk
from declip_tpu.ops.filip_ops import late_interaction_logits as jax_li
from declip_tpu.ops.filip_pallas import late_interaction_logits_pallas

from declip_tpu_torch.losses import mlm_loss
from declip_tpu_torch.models.clip_model import compact_mlm
from declip_tpu_torch.models.filip_model import topk_token_select
from declip_tpu_torch.ops import filip_late_interaction as fli
from declip_tpu_torch.ops import filip_ops

SHAPES = [  # (B, N1, GB, N2, D), tests/test_filip_pallas.py:26-30
    (8, 77, 128, 16, 256),   # text query x selected image keys
    (8, 50, 130, 16, 256),   # image query, GB not a tile multiple
    (6, 5, 40, 3, 64),       # tiny odd everything
]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _data(seed, b, n1, gb, n2, d):
    rng = np.random.default_rng(seed)
    return (_unit(rng, (b, n1, d)), _unit(rng, (gb, n2, d)),
            np.float32(2.5), rng.normal(size=(b, gb)).astype(np.float32))


def _jax_value_and_grads(d1, d2, scale, w):
    def f(a, b, s):
        return (jax_li(a, b, s) * w).sum()

    out = jax_li(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(scale))
    grads = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(scale))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_value_and_grads(fn, d1, d2, scale, w, dtype=torch.float32):
    leaves = [torch.from_numpy(d1).to(dtype).requires_grad_(),
              torch.from_numpy(d2).to(dtype).requires_grad_(),
              torch.tensor(scale).requires_grad_()]
    out = fn(*leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    return out.detach(), grads


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_late_interaction_matches_jax(shape, impl):
    """The port's kernel route (on the CPU: K3's plain version forward and
    K4's/K5's backward, through the autograd Function) and its chunked path
    (with a chunk that leaves a ragged last chunk), forward and the d1, d2
    and scale gradients."""
    d1, d2, scale, w = _data(sum(shape), *shape)
    want, want_grads = _jax_value_and_grads(d1, d2, scale, w)
    if impl == "pallas":
        fn = fli.late_interaction_logits_kernel
    else:
        def fn(a, b, s):
            return filip_ops.late_interaction_logits(a, b, s, chunk_size=48)
    launches = (fli.late_interaction_fwd.launches,
                fli.late_interaction_bwd_d1.launches,
                fli.late_interaction_bwd_d2.launches)
    out, grads = _torch_value_and_grads(fn, d1, d2, scale, w)
    assert out.dtype == torch.float32 and out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
    for name, g, r in zip(("d1", "d2", "scale"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **GRAD_TOL)
    assert (fli.late_interaction_fwd.launches,
            fli.late_interaction_bwd_d1.launches,
            fli.late_interaction_bwd_d2.launches) == launches  # CPU: none


def test_exact_ties_split_evenly():
    """Duplicated key tokens make exact ties: the gradient splits evenly
    between them, as jax.grad of jnp.max does (torch.max(dim) would send it
    all to one)."""
    d1, d2, scale, w = _data(7, 4, 9, 12, 5, 32)
    d2[:, 3] = d2[:, 1]           # a tie in every key item
    d2[::2, 4] = d2[::2, 1]       # a three-way tie in every other item
    d1[:, 2] = d1[:, 0]           # and duplicated query rows
    want, want_grads = _jax_value_and_grads(d1, d2, scale, w)
    out, grads = _torch_value_and_grads(fli.late_interaction_logits_kernel,
                                        d1, d2, scale, w)
    np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
    for name, g, r in zip(("d1", "d2", "scale"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **GRAD_TOL)
    # the tied tokens took equal shares where they won
    dd2 = grads[1].numpy()
    np.testing.assert_array_equal(dd2[:, 3], dd2[:, 1])
    np.testing.assert_array_equal(dd2[::2, 4], dd2[::2, 1])
    assert np.abs(dd2[:, 1]).max() > 0


def test_bwd_plain_follows_the_tpu_kernel_weights():
    """late_interaction_bwd_plain routes g / (N1 * ties) to each winner: on
    a hand-built case, one query row and one key item with a two-way tie."""
    d1 = torch.tensor([[[1.0, 0.0]]])                    # B=1, N1=1
    d2 = torch.tensor([[[0.5, 0.0], [0.5, 1.0], [0.2, 0.0]]])  # two tie
    dd1, dd2 = fli.late_interaction_bwd_plain(d1, d2, torch.tensor([[4.0]]))
    torch.testing.assert_close(dd1, torch.tensor([[[2.0, 2.0]]]))
    torch.testing.assert_close(
        dd2, torch.tensor([[[2.0, 0.0], [2.0, 0.0], [0.0, 0.0]]]))
    torch.testing.assert_close(fli.late_interaction_raw_plain(d1, d2),
                               torch.tensor([[0.5]]))


def test_bf16_inputs_close_to_fp32():
    """bf16 inputs: the logits within 2e-2 of the fp32 inputs' (JAX); the
    gradients, in bf16, within 2e-2 of JAX's fp32 gradients at the
    bf16-rounded inputs (rounding the inputs moves some max winners, so the
    fp32 inputs' gradients are not the reference for those)."""
    b, n1, gb, n2, d = 8, 25, 128, 16, 128
    d1, d2, scale, w = _data(3, b, n1, gb, n2, d)
    ref, _ = _jax_value_and_grads(d1, d2, scale, w)
    out, grads = _torch_value_and_grads(fli.late_interaction_logits_kernel,
                                        d1, d2, scale, w, torch.bfloat16)
    assert out.dtype == torch.float32
    assert grads[0].dtype == grads[1].dtype == torch.bfloat16
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2, atol=2e-2)
    rounded = [torch.from_numpy(x).bfloat16().float().numpy()
               for x in (d1, d2)]
    _, ref_grads = _jax_value_and_grads(*rounded, scale, w)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.float().numpy(), r, rtol=2e-2,
                                   atol=2e-2)


def test_pallas_kernel_interpret_matches_port():
    """The TPU kernel itself (Pallas interpret mode, slow: one tiny shape)
    against the port's plain versions, forward and gradients."""
    shape = (6, 5, 40, 3, 64)
    d1, d2, scale, w = _data(11, *shape)

    def f(a, b, s):
        return (late_interaction_logits_pallas(a, b, s, interpret=True)
                * w).sum()

    args = (jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(scale))
    want = np.asarray(late_interaction_logits_pallas(*args, interpret=True))
    want_grads = jax.grad(f, argnums=(0, 1, 2))(*args)
    out, grads = _torch_value_and_grads(fli.late_interaction_logits_kernel,
                                        d1, d2, scale, w)
    np.testing.assert_allclose(out.numpy(), want, **FWD_TOL)
    for g, r in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)


def test_dispatch_selection(monkeypatch):
    """Config > env > default (the kernel route); impl xla is the chunked
    path on any device; an unknown impl raises."""
    monkeypatch.delenv("DECLIP_FILIP_LI_IMPL", raising=False)
    kernel, chunked = (filip_ops.late_interaction_logits_kernel,
                       filip_ops.late_interaction_logits)
    assert filip_ops.dispatch_late_interaction({}) is kernel
    assert filip_ops.dispatch_late_interaction(None) is kernel
    assert filip_ops.dispatch_late_interaction(
        {"filip_dense": {"impl": "xla"}}) is chunked
    monkeypatch.setenv("DECLIP_FILIP_LI_IMPL", "xla")
    assert filip_ops.dispatch_late_interaction({}) is chunked
    assert filip_ops.dispatch_late_interaction(
        {"filip_dense": {"impl": "pallas"}}) is kernel
    monkeypatch.setenv("DECLIP_FILIP_LI_IMPL", "triton")
    with pytest.raises(ValueError, match="not in"):
        filip_ops.dispatch_late_interaction({})
    # the wide, unselected key set takes the kernel route too (N2 = 77)
    monkeypatch.delenv("DECLIP_FILIP_LI_IMPL")
    d1, d2, scale, _ = _data(5, 2, 7, 3, 77, 16)
    got = filip_ops.dispatch_late_interaction({})(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.tensor(scale))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_li(d1, d2, scale)), **FWD_TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch functions take CUDA tensors only; on the CPU the plain
    versions run, chosen by the autograd Function."""
    d1, d2 = torch.zeros(2, 3, 8), torch.zeros(4, 5, 8)
    g = torch.zeros(2, 4)
    winners = torch.zeros(6, 4, 1, dtype=torch.int32)
    for fn, args in ((fli.late_interaction_fwd, (d1, d2)),
                     (fli.late_interaction_bwd_d1, (winners, d2, g)),
                     (fli.late_interaction_bwd_d2, (winners, d1, g, 5))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)


def _grid_pair(seed, b, n1, gb, n2, d):
    """Small integer features, so that every similarity is exact and ties
    are common. Query token 0 of every item and key token 0 of every item
    are all 3s, the largest similarity there is, and key token 0 is copied
    to the last token of every item and the one before it of every other
    item: two-way and three-way ties of the max."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(-3, 4, size=(b, n1, d)).astype(np.float32)
    d2 = rng.integers(-3, 4, size=(gb, n2, d)).astype(np.float32)
    d1[:, 0] = 3
    d2[:, 0] = 3
    d2[:, n2 - 1] = d2[:, 0]
    d2[::2, n2 - 2] = d2[::2, 0]
    g = rng.normal(size=(b, gb)).astype(np.float32)
    return d1, d2, g


@pytest.mark.parametrize("n2", [3, 16, 33, 77])
def test_winners_plain_matches_numpy(n2):
    """K3's winner mask (its plain version): bit m % 32 of word m // 32 of
    [B*N1, GB, ceil(N2/32)] is set exactly where similarity m equals its
    key item's max, ties included (1-, 2- and 3-word layouts)."""
    b, n1, gb, d = 3, 5, 4, 8
    d1, d2, _ = _grid_pair(n2, b, n1, gb, n2, d)
    got = fli.late_interaction_winners_plain(torch.from_numpy(d1),
                                             torch.from_numpy(d2))
    assert got.dtype == torch.int32
    assert got.shape == (b * n1, gb, (n2 + 31) // 32)
    sim = np.einsum("bnd,lmd->bnlm", d1, d2).reshape(b * n1, gb, n2)
    want = sim == sim.max(axis=-1, keepdims=True)
    words = got.numpy().view(np.uint32)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(b * n1, gb, -1)
    np.testing.assert_array_equal(bits[..., :n2].astype(bool), want)
    assert not bits[..., n2:].any()
    assert (want.sum(-1) >= 2).any() and (want.sum(-1) >= 3).any()


@pytest.mark.parametrize("case", ["ties", "nan_key", "nan_query"])
def test_mask_route_matches_bwd_plain(case):
    """The kernels' dataflow on the CPU (the winners, then K4's and K5's
    plain versions from the mask) against late_interaction_bwd_plain, which
    forms the winners from the similarities: equal on exact ties, and NaN in
    the same places for a NaN key token or query row (a NaN max sets no
    bit, and its pair's weights are all NaN)."""
    b, n1, gb, n2, d = 3, 7, 5, 16, 16
    d1, d2, g = _grid_pair(17, b, n1, gb, n2, d)
    if case == "nan_key":
        d2[2, 4, 3] = np.nan
    elif case == "nan_query":
        d1[1, 2, 5] = np.nan
    d1, d2, g = map(torch.from_numpy, (d1, d2, g))
    winners = fli.late_interaction_winners_plain(d1, d2)
    got1 = fli.late_interaction_bwd_d1_plain(winners, d2, g)
    got2 = fli.late_interaction_bwd_d2_plain(winners, d1, g, n2)
    want1, want2 = fli.late_interaction_bwd_plain(d1, d2, g)
    for got, want in ((got1, want1), (got2, want2)):
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)
    if case != "ties":
        assert torch.isnan(want1).any() and torch.isnan(want2).any()
        assert not (torch.isnan(want1).all() and torch.isnan(want2).all())


def test_compact_mlm_and_mlm_loss_match_jax():
    rng = np.random.default_rng(2)
    b, length, width, vocab = 5, 77, 16, 50
    words = rng.normal(size=(b, length, width)).astype(np.float32)
    labels = np.full((b, length), -100, np.int32)
    for r, n in enumerate([0, 3, 24, 30, 77]):  # none, few, cap, over cap
        pos = rng.choice(length, size=n, replace=False)
        labels[r, pos] = rng.integers(0, vocab, size=n)
    jw, jl = jax_compact_mlm(jnp.asarray(words), jnp.asarray(labels), 24)
    tw, tl = compact_mlm(torch.from_numpy(words),
                         torch.from_numpy(labels).long(), 24)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    logits = rng.normal(size=(b, 24, vocab)).astype(np.float32)
    np.testing.assert_allclose(
        float(mlm_loss(torch.from_numpy(logits), tl)),
        float(jax_mlm_loss(jnp.asarray(logits), jl)), rtol=1e-6)
    none = np.full((b, 24), -100, np.int32)
    assert float(mlm_loss(torch.from_numpy(logits),
                          torch.from_numpy(none))) == 0.0


def test_topk_token_select_matches_jax():
    rng = np.random.default_rng(4)
    f1, f2 = _unit(rng, (3, 49, 32)), _unit(rng, (3, 77, 32))
    want = jax_topk(jnp.asarray(f1), jnp.asarray(f2), 16)
    got = topk_token_select(torch.from_numpy(f1), torch.from_numpy(f2), 16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
