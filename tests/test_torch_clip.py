"""Tiny CLIP ViT-B/32: the port (declip_tpu_torch) against the JAX package.

The JAX model is built with ``attn_impl: pallas`` so its attention runs the
Pallas kernel in interpret mode; its numpy params cross over through the
port's ``state_from_jax_variables`` and ``load_state_dict(strict=True)``.
Both sides compute in fp32 (JAX at matmul precision 'highest', see
conftest). Tolerance rtol 1e-4 / atol 1e-5: two layers of matmuls,
LayerNorms (flax takes the variance as E[x^2]-E[x]^2, torch in two passes)
and softmaxes summed in different orders, each off by ~1e-7 relative.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from declip_tpu_torch.convert import state_from_jax_variables
from declip_tpu_torch.models import model_entry as torch_model_entry
from declip_tpu_torch.ops.flash_attention import flash_attention

RES, PATCH = 32, 8
EOT = 7  # an eot id below other ids in the rows, so argmax pooling differs
RTOL, ATOL = 1e-4, 1e-5


def _kwargs(vocab):
    return {
        "image_encode": {"embed_dim": 32, "input_resolution": RES,
                         "patch_size": PATCH, "width": 64, "layers": 2,
                         "heads": 2, "attn_impl": "pallas"},
        "text_encode": {"embed_dim": 32, "transformer_width": 64,
                        "transformer_heads": 2, "transformer_layers": 2,
                        "vocab_size": vocab, "eot_id": EOT,
                        "attn_impl": "pallas"},
        "clip": {"use_allgather": False},
    }


@pytest.fixture(scope="module")
def pair():
    from declip_tpu.models import model_entry
    from declip_tpu.tokenizer import get_tokenizer

    vocab = get_tokenizer(None).vocab_size
    cfg = {"type": "clip_vitb32", "kwargs": _kwargs(vocab)}
    jmodel = model_entry(cfg)
    batch = {"images": jnp.zeros((1, RES, RES, 3), jnp.float32),
             "tokens": jnp.ones((1, 77), jnp.int32)}
    variables = jax.jit(
        lambda: jmodel.init(jax.random.PRNGKey(0), batch, train=True))()
    variables = {"params": jax.tree_util.tree_map(np.asarray,
                                                  variables["params"])}
    tmodel = torch_model_entry(cfg).eval()
    tmodel.load_state_dict(state_from_jax_variables(variables), strict=True)
    return jmodel, variables, tmodel, vocab


def _tokens(vocab, seed=0):
    """Rows of ids above EOT with one EOT each, plus a row with no EOT
    (pools position 0, as jnp.argmax over an all-zero mask does)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(EOT + 1, vocab, size=(4, 77)).astype(np.int32)
    for r, pos in enumerate((5, 20, 76)):
        toks[r, pos] = EOT
        toks[r, pos + 1:] = 0
    assert (toks.argmax(-1)[:3] != np.array([5, 20, 76])).all()
    return toks


def test_state_dict_equals_jax_converter(pair):
    """The port's converter is a copy of declip_tpu.tools.convert's
    mapping: same keys, same values, and exactly the port's parameters."""
    from declip_tpu.tools.convert import variables_to_torch_state

    _, variables, tmodel, _ = pair
    ours = state_from_jax_variables(variables)
    theirs = variables_to_torch_state(variables)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), k)
    assert set(tmodel.state_dict()) == set(ours)
    assert "visual.transformer.resblocks.1.attn.in_proj_weight" in ours
    assert tuple(ours["visual.conv1.weight"].shape) == (64, 3, PATCH, PATCH)


@pytest.mark.parametrize("res", [RES, 48, 16],
                         ids=["native", "upsampled-pos", "downsampled-pos"])
def test_encode_image_matches_jax(pair, res):
    """Off-resolution inputs resize the positional grid (vit.py:94-103):
    48 px upsamples the 4x4 grid to 6x6, 16 px downsamples it (antialiased)
    to 2x2."""
    jmodel, variables, tmodel, _ = pair
    imgs = np.random.default_rng(res).normal(
        size=(3, res, res, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, method="encode_image"))(variables, imgs))
    with torch.inference_mode():
        got = tmodel.encode_image(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encode_text_first_eot_pooling(pair):
    jmodel, variables, tmodel, vocab = pair
    toks = _tokens(vocab)
    want = np.asarray(jax.jit(lambda v, t: jmodel.apply(
        v, t, method="encode_text"))(variables, toks))
    with torch.inference_mode():
        got = tmodel.encode_text(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_full_forward_matches_jax(pair):
    jmodel, variables, tmodel, vocab = pair
    imgs = np.random.default_rng(9).normal(
        size=(4, RES, RES, 3)).astype(np.float32)
    toks = _tokens(vocab, seed=1)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, {"images": imgs, "tokens": toks})
    before = flash_attention.launches
    with torch.inference_mode():
        got = tmodel({"images": torch.from_numpy(imgs),
                      "tokens": torch.from_numpy(toks).long()})
    assert flash_attention.launches == before  # CPU tensors: plain version
    assert sorted(got) == sorted(want)
    for k in ("image_embed", "text_embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            np.linalg.norm(got[k].numpy(), axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(got["logit_scale"]),
                               float(want["logit_scale"]), rtol=1e-6)


def test_seeded_init_matches_jax_scheme():
    """load_eval_model's random init: the JAX init stds, reproducible from
    the seed."""
    cfg = {"type": "clip_vitb32", "kwargs": _kwargs(515)}
    a, b = torch_model_entry(cfg), torch_model_entry(cfg)
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    sd = a.state_dict()
    w = 64
    qkv = sd["visual.transformer.resblocks.0.attn.in_proj_weight"]
    assert abs(qkv.std().item() - w ** -0.5) < 0.1 * w ** -0.5
    proj = sd["encode_text.transformer.resblocks.0.mlp.c_proj.weight"]
    want = w ** -0.5 * (2 * 2) ** -0.5
    assert abs(proj.std().item() - want) < 0.1 * want
    assert abs(sd["encode_text.token_embedding.weight"].std().item()
               - 0.02) < 0.002
    np.testing.assert_allclose(sd["logit_scale"].item(), np.log(1 / 0.07),
                               rtol=1e-6)
    assert not sd["visual.transformer.resblocks.0.attn.in_proj_bias"].any()
    conv = sd["visual.conv1.weight"]
    lecun = (1 / (3 * PATCH * PATCH)) ** 0.5 / .87962566103423978
    assert conv.abs().max().item() <= 2 * lecun + 1e-6


def test_unported_options_raise(monkeypatch):
    """A Bert text tower is ported (models/hf_text.py) and needs local
    weights: without them it raises as the JAX package's does. A dtype
    that is no floating type raises."""
    monkeypatch.delenv("DECLIP_HF_TEXT_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="needs local pretrained"):
        torch_model_entry({"type": "clip_vitb32", "kwargs": {
            "text_encode": {"text_encode_type": "Bert", "vocab_size": 10}}})
    with pytest.raises(ValueError, match="not a floating dtype"):
        torch_model_entry({"type": "clip_vitb32",
                           "kwargs": {"dtype": "int8"}})
