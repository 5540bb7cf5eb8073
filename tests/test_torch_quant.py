"""The port's int8 Dense path (declip_tpu_torch/ops/quant.py) and its FLOP
counting (declip_tpu_torch/utils/flops.py) against the JAX package, on the
CPU.

- ``quantize_rowwise`` and ``quantize_colwise`` equal JAX's bit for bit on
  seeded fp32 inputs, rows of exact half-LSB ties included (both round half
  to even);
- the int8 dense equals a JAX ``nn.Dense`` under ``int8_inference`` on the
  same weights and inputs: the int32 sum exactly (int8 operands), the
  output within 1 ulp of fp32 (the rescale's two products and the bias add
  are the same fp32 operations; XLA may fuse them);
- the registered kernels' FLOP formulas equal the count of their plain
  versions' matmuls on the CPU (K1, K2, K3), K4's and K5's formula counts
  the winners (one a query token and key item), and ``estimate_flops`` of a
  tiny ViT tower equals the hand-summed products and K1 formula exactly.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu.ops import quant as jax_quant
from declip_tpu_torch.ops import filip_late_interaction as fli
from declip_tpu_torch.ops import flash_attention as fa
from declip_tpu_torch.ops import quant
from declip_tpu_torch.utils.flops import estimate_flops, flops_by_operator


def _tied(rng, shape):
    """Seeded normals whose first row (and column) holds exact half-LSB
    ties: with absmax 127 the scale is 1, and x/scale lands on k + 0.5."""
    x = rng.normal(size=shape).astype(np.float32)
    ties = (np.arange(shape[1], dtype=np.float32) % 40 - 20) + 0.5
    x[0, :] = ties
    x[0, 0] = 127.0
    x[:, 0] = np.resize(ties, shape[0])
    x[0, 0] = 127.0
    return x


@pytest.mark.parametrize("name", ["quantize_rowwise", "quantize_colwise"])
def test_quantizers_match_jax_bit_for_bit(name):
    x = _tied(np.random.default_rng(0), (48, 96))
    want_q, want_s = getattr(jax_quant, name)(jnp.asarray(x))
    got_q, got_s = getattr(quant, name)(torch.from_numpy(x))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the tie row (column) has scale 1, so its codes are the ties rounded
    # half to even, which half away from zero would miss
    ties = x[0, 1:] if name == "quantize_rowwise" else x[1:, 0]
    codes = (got_q[0, 1:] if name == "quantize_rowwise"
             else got_q[1:, 0]).numpy()
    np.testing.assert_array_equal(codes, np.round(ties))
    assert np.any(codes != np.trunc(ties + np.sign(ties) * 0.5))


def test_int8_dense_matches_jax_dense():
    import flax.linen as nn

    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 96)).astype(np.float32)
    dense = nn.Dense(128)
    variables = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape),
                                        jnp.float32), variables)
    with jax_quant.int8_inference(min_dim=64):
        want = np.asarray(dense.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"])  # [in, out]
    bias = np.array(variables["params"]["bias"])
    got = quant.int8_dense(torch.from_numpy(x),
                           torch.from_numpy(kernel.T.copy()),
                           torch.from_numpy(bias), torch.float32)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)

    # the int32 sum is exact: the quantized operands' product in int64
    qx, _ = quant.quantize_rowwise(torch.from_numpy(x))
    qw, _ = quant.quantize_colwise(torch.from_numpy(kernel))
    acc = quant._int32_matmul(qx, qw.t().contiguous())
    np.testing.assert_array_equal(
        acc.numpy(), qx.numpy().astype(np.int64) @ qw.numpy().astype(np.int64))


def test_int32_matmul_pads_rows_and_widths():
    """One row and widths that are no multiple of 8 (the card's
    ``_int_mm`` takes neither) give the exact product."""
    g = torch.Generator().manual_seed(2)
    qx = torch.randint(-127, 128, (1, 13), generator=g, dtype=torch.int8)
    qw = torch.randint(-127, 128, (5, 13), generator=g, dtype=torch.int8)
    got = quant._int32_matmul(qx, qw)
    assert got.shape == (1, 5) and got.dtype == torch.int32
    assert torch.equal(got.long(), qx.long() @ qw.long().t())


def test_weight_codes_are_kept_per_version():
    """A live weight is quantized once: a second product reuses its codes,
    an in-place update (a new version) quantizes it again, and each product
    equals one from a fresh copy of the weight bit for bit. ``torch.export``
    keeps nothing: its graph quantizes the weight at each call."""
    g = torch.Generator().manual_seed(6)
    w = torch.nn.Parameter(torch.randn(64, 96, generator=g))
    x = torch.randn(5, 96, generator=g)

    def fresh():
        return quant.int8_dense(x, w.detach().clone(), None, torch.float32)

    with torch.no_grad():
        first = quant.int8_dense(x, w, None, torch.float32)
        kept = quant._CODES[w]
        assert quant.int8_dense(x, w, None, torch.float32).equal(first)
        assert quant._CODES[w][1] is kept[1]
        assert first.equal(fresh())
        w.mul_(2.0)
        moved = quant.int8_dense(x, w, None, torch.float32)
        assert quant._CODES[w][0] > kept[0]
        assert quant._CODES[w][1] is not kept[1]
        assert moved.equal(fresh())

    class Dense(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.randn(64, 96,
                                                         generator=g))

        def forward(self, x):
            return quant.int8_dense(x, self.weight, None, torch.float32)

    module = Dense()
    with torch.no_grad():
        program = torch.export.export(module, (x,))
    assert module.weight not in quant._CODES
    targets = {str(n.target) for n in program.graph.nodes}
    assert "aten.round.default" in targets and "aten.abs.default" in targets
    with torch.no_grad():
        assert program.module()(x).equal(module(x))


def test_routes_only_inside_the_context():
    x = torch.zeros(2, 64)
    assert not quant.routes(x, 64)
    with quant.int8_inference(min_dim=64):
        assert quant.routes(x, 64) and not quant.routes(x, 63)
        with quant.int8_inference(min_dim=100):
            assert not quant.routes(x, 128)
        assert quant.routes(x, 64)
    assert not quant.routes(x, 64)


def _flops_of(fn, *args):
    return sum(flops_by_operator(fn, *args).values())


@pytest.mark.parametrize("causal", [False, True])
def test_attention_formulas_equal_the_plain_matmuls(causal):
    """K1's formula is the plain forward's two products (a causal mask is
    counted in full, as the plain matmuls are), K2's the plain backward's
    five."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, 17, 32, generator=g) for _ in range(4))
    scale = 32 ** -0.5
    ops = torch.ops.declip_tpu_torch
    fwd = flops_by_operator(ops.flash_attn_fwd, q, k, v, causal, scale,
                            False)
    assert fwd == {"declip_tpu_torch.flash_attn_fwd":
                   _flops_of(fa.attention_plain, q, k, v, causal, scale)}
    o, lse = ops.flash_attn_fwd(q, k, v, causal, scale, True)
    bwd = flops_by_operator(ops.flash_attn_bwd, q, k, v, o, lse, do, causal,
                            scale)
    assert bwd == {"declip_tpu_torch.flash_attn_bwd": _flops_of(
        fa.attention_bwd_plain, q, k, v, do, causal, scale)}
    assert 2 * bwd["declip_tpu_torch.flash_attn_bwd"] == \
        5 * fwd["declip_tpu_torch.flash_attn_fwd"]


def test_late_interaction_formulas():
    """K3's formula is its plain version's similarity product; K4 and K5
    count one winner a query token and key item, 2*B*N1*GB*D each, where
    their plain versions multiply a dense weight over all N2 tokens."""
    g = torch.Generator().manual_seed(4)
    b, n1, gb, n2, d = 3, 5, 4, 7, 16
    d1, d2 = torch.randn(b, n1, d, generator=g), torch.randn(gb, n2, d,
                                                             generator=g)
    grad = torch.randn(b, gb, generator=g)
    ops = torch.ops.declip_tpu_torch
    assert _flops_of(ops.late_interaction_fwd, d1, d2) == _flops_of(
        fli.late_interaction_raw_plain, d1, d2) == 2 * b * gb * n1 * n2 * d
    _, winners = ops.late_interaction_fwd(d1, d2)
    assert _flops_of(ops.late_interaction_bwd_d1, winners, d2, grad) == \
        _flops_of(ops.late_interaction_bwd_d2, winners, d1, grad, n2) == \
        2 * b * n1 * gb * d
    assert _flops_of(fli.late_interaction_bwd_d1_plain, winners, d2,
                     grad) == n2 * 2 * b * n1 * gb * d


def test_estimate_flops_of_a_tower_is_the_hand_sum():
    from declip_tpu_torch.models.vit import VisualTransformer

    b, res, p, w, layers, heads, embed = 2, 32, 8, 64, 2, 2, 32
    tower = VisualTransformer(input_resolution=res, patch_size=p, width=w,
                              layers=layers, heads=heads, embed_dim=embed)
    tower.init_weights(torch.Generator().manual_seed(5))
    x = torch.zeros(b, res, res, 3)
    n = (res // p) ** 2
    length = n + 1
    want = (2 * b * n * (p * p * 3) * w                      # patch embed
            + layers * (2 * b * length * w * 3 * w           # qkv
                        + 4 * b * heads * length ** 2 * (w // heads)  # K1
                        + 2 * b * length * w * w             # out proj
                        + 2 * 2 * b * length * w * 4 * w)    # MLP
            + 2 * b * w * embed)                             # proj
    with torch.no_grad():
        assert estimate_flops(tower, x) == want
    assert estimate_flops(lambda: None) is None
