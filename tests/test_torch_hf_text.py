"""The port's HuggingFace text towers (declip_tpu_torch/models/hf_text.py)
against the JAX package's ``HFTextEncoder``.

Tiny Bert, Roberta and GPT2 checkpoints are written in the test (torch
safetensors, which both packages' transformers models load), so nothing is
downloaded. The JAX tower is initialised from a seed (its backbone's
weights then differ from the checkpoint's, so a weight that failed to
carry would show); its variables are carried across with
``convert.state_from_jax_variables`` and loaded with ``strict=True`` over
the port's tower built from the checkpoint; one padded row exercises the
attention mask. Pooled embeddings and token
features agree in fp32 within the JAX package's own tolerance for its
Flax-vs-torch check (tests/test_hf_text.py): rtol 2e-3, atol 2e-4.

Roberta counts its positions from the pad id in the reference's torch
model and in the port, from 0 in the JAX package's call of the bare Flax
module (a fault of the JAX package that the port does not copy). Its
towers are held to the JAX tower's own modules and variables fed the
reference's positions, and the JAX tower's default is shown to differ.
"""

import torch_threads  # noqa: F401  (one torch thread: see the module)
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from declip_tpu_torch.convert import state_from_jax_variables  # noqa: E402
from declip_tpu_torch.models.hf_text import (  # noqa: E402
    HFTextEncoder,
    build_hf_text,
)

RTOL, ATOL = 2e-3, 2e-4
EMBED = 24
REPO = __file__.rsplit("/", 2)[0]


def _save(kind, path):
    from transformers import (
        BertConfig,
        BertModel,
        GPT2Config,
        GPT2Model,
        RobertaConfig,
        RobertaModel,
    )

    torch.manual_seed(0)
    common = dict(vocab_size=100, num_hidden_layers=2, num_attention_heads=2,
                  hidden_size=32, intermediate_size=64)
    if kind == "bert":
        model = BertModel(BertConfig(max_position_embeddings=64,
                                     pad_token_id=0, **common))
    elif kind == "roberta":
        # positions start after the pad id (1), so 16 tokens need 18
        model = RobertaModel(RobertaConfig(max_position_embeddings=64,
                                           pad_token_id=1, **common))
    else:
        model = GPT2Model(GPT2Config(vocab_size=100, n_embd=32, n_layer=2,
                                     n_head=2, n_positions=64))
    model.eval().save_pretrained(path)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {kind: _save(kind, root / kind)
            for kind in ("bert", "roberta", "gpt2")}


TOWERS = [("Bert", "bert", 0), ("Bert_large", "bert", 0),
          ("Roberta", "roberta", 1), ("Roberta_large", "roberta", 1),
          ("GPT2", "gpt2", 0)]


def _tokens(pad_id):
    toks = np.random.default_rng(0).integers(2, 100, size=(4, 16))
    toks[0, 10:] = pad_id  # one padded row exercises the attention mask
    return toks.astype(np.int32)


def _reference_positions(toks, pad_id):
    """transformers' ``create_position_ids_from_input_ids``: positions
    count the non-pad tokens from ``pad_id + 1``; a pad sits at pad_id."""
    mask = toks != pad_id
    return (np.cumsum(mask, axis=1) * mask + pad_id).astype(np.int32)


def _jax_roberta(m, toks, pos):
    """The JAX ``HFTextEncoder``'s own forward with explicit positions."""
    attn = (toks != m.pad_id).astype(jnp.int32)
    words = m.backbone(input_ids=toks, attention_mask=attn,
                       position_ids=pos).last_hidden_state
    return m.text_projection(words[:, 0, :]), words


def _carry(params) -> dict:
    """A standalone tower's JAX params -> the port's tower state dict."""
    state = state_from_jax_variables({"params": {"text": params}})
    return {k[len("encode_text."):]: v for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_towers(checkpoints):
    """{type: (params, tokens, pooled, words)} from the JAX package, each
    checkpoint's tower initialised and applied once (Roberta at the
    reference's positions; its JAX default under "<type>:default"). The
    JAX package's ``Bert_large`` and ``Roberta_large`` run the code of
    ``Bert`` and ``Roberta`` (only the names' prefixes are read), so on
    one checkpoint they give the same numbers, and are taken from them."""
    from declip_tpu.models.hf_text import build_hf_text as jax_build

    out = {}
    for name, kind, pad in TOWERS:
        if name.endswith("_large"):
            out[name] = out[name[:-len("_large")]]
            out[f"{name}:default"] = out.get(
                f"{name[:-len('_large')]}:default")
            continue
        enc = jax_build(name, embed_dim=EMBED,
                        pretrained_path=checkpoints[kind])
        toks = _tokens(pad)
        variables = jax.jit(enc.init)(jax.random.PRNGKey(0), toks)
        apply = jax.jit(lambda v, t: enc.apply(v, t, return_dense=True))
        pooled, words = apply(variables, toks)
        params = jax.device_get(variables["params"])
        if kind == "roberta":
            out[f"{name}:default"] = np.asarray(words)
            pooled, words = jax.jit(lambda v, t, p: enc.apply(
                v, t, p, method=_jax_roberta))(
                    variables, toks, _reference_positions(toks, pad))
        out[name] = (params, toks, np.asarray(pooled), np.asarray(words))
    return out


@pytest.mark.parametrize("name", [t[0] for t in TOWERS])
def test_tower_matches_jax(checkpoints, jax_towers, name):
    """Pooled and token features of each tower type against JAX's, from
    JAX's variables loaded strictly (the backbone's and the projection's):
    Bert and Roberta pool the CLS token, GPT2 the masked mean."""
    params, toks, pooled, words = jax_towers[name]
    kind = dict((t[0], t[1]) for t in TOWERS)[name]
    tower = build_hf_text(name, EMBED, pretrained_path=checkpoints[kind])
    tower.load_state_dict(_carry(params), strict=True)
    tower.train()  # the backbone stays deterministic, as JAX's
    assert not tower.backbone.training
    with torch.no_grad():
        got_pooled, got_words = tower(torch.from_numpy(toks.copy()),
                                      return_dense=True)
    assert got_pooled.shape == (4, EMBED)
    np.testing.assert_allclose(got_words.numpy(), words, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_pooled.numpy(), pooled, rtol=RTOL,
                               atol=ATOL)
    assert tower.vocab_size == 100
    assert tower.pad_id == (1 if name.startswith("Roberta") else 0)
    if kind == "roberta":  # the JAX package's positions from 0 differ
        assert np.abs(jax_towers[f"{name}:default"] - words).max() > 0.1


def test_gpt2_conv1d_weights_are_transposed(checkpoints, jax_towers):
    """GPT2's Conv1D keeps its torch weight [in, out], its Flax kernel
    [out, in]: the carried ``attn.c_proj`` is the Flax kernel transposed.
    The matrix is square, so a missed transpose would load without a
    complaint: carried as it is, the tower's features leave JAX's."""
    params, toks, _, words = jax_towers["GPT2"]
    state = _carry(params)
    kernel = np.asarray(params["backbone"]["h"]["0"]["attn"]["c_proj"][
        "kernel"])
    assert kernel.shape[0] == kernel.shape[1]
    key = "backbone.h.0.attn.c_proj.weight"
    np.testing.assert_array_equal(state[key].numpy(), kernel.T)
    state[key] = torch.from_numpy(kernel.copy())
    tower = build_hf_text("GPT2", EMBED, pretrained_path=checkpoints["gpt2"])
    tower.load_state_dict(state, strict=True)
    with torch.no_grad():
        _, got = tower(torch.from_numpy(toks.copy()), return_dense=True)
    assert np.abs(got.numpy() - words).max() > 100 * ATOL


def test_bf16_tower_keeps_fp32_parameters(checkpoints):
    """dtype bfloat16: fp32 parameters, the features in bf16 and near the
    fp32 tower's, a gradient for the backbone and the projection."""
    t32 = build_hf_text("Bert", EMBED, pretrained_path=checkpoints["bert"])
    t16 = build_hf_text("Bert", EMBED, pretrained_path=checkpoints["bert"],
                        dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    t32.init_weights(g)
    t16.load_state_dict(t32.state_dict())
    assert all(p.dtype == torch.float32 for p in t16.parameters())
    toks = torch.from_numpy(_tokens(0))
    out16, words16 = t16(toks, return_dense=True)
    assert out16.dtype == words16.dtype == torch.bfloat16
    out16.float().sum().backward()
    assert t16.text_projection.weight.grad is not None
    assert t16.backbone.embeddings.word_embeddings.weight.grad is not None
    with torch.no_grad():
        out32 = t32(toks)
    np.testing.assert_allclose(out16.detach().float().numpy(),
                               out32.numpy(), atol=0.05, rtol=0.05)


def test_init_weights_keeps_the_pretrained_backbone(checkpoints):
    from transformers import BertModel

    tower = build_hf_text("Bert", EMBED, pretrained_path=checkpoints["bert"])
    tower.init_weights(torch.Generator().manual_seed(3))
    ref = BertModel.from_pretrained(checkpoints["bert"]).state_dict()
    for k, v in tower.backbone.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_missing_weights_raise(tmp_path, monkeypatch):
    """A missing directory raises the JAX message; DECLIP_HF_TEXT_PATH is
    read where no path is given."""
    with pytest.raises(FileNotFoundError, match="zero-egress"):
        HFTextEncoder("Bert", str(tmp_path / "nonexistent"), embed_dim=8)
    monkeypatch.setenv("DECLIP_HF_TEXT_PATH", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="absent"):
        build_hf_text("Bert", 8)


def test_env_path_builds_the_tower(checkpoints, monkeypatch):
    monkeypatch.setenv("DECLIP_HF_TEXT_PATH", checkpoints["gpt2"])
    assert build_hf_text("GPT2", 8).backbone.config.model_type == "gpt2"


def test_without_transformers_building_raises(checkpoints, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers' package"):
        build_hf_text("Bert", 8, pretrained_path=checkpoints["bert"])


def _declip_kwargs(bert_dir):
    return {
        "image_encode": {"embed_dim": 64, "input_resolution": 32,
                         "patch_size": 8, "width": 64, "layers": 1,
                         "heads": 2},
        "text_encode": {"text_encode_type": "Bert",
                        "text_model_utils": {"pretrained_path": bert_dir},
                        "embed_dim": 64},
        "clip": {"use_allgather": False, "text_mask_type": "MLM",
                 "return_nn_bank": True, "feature_dim": 64, "nn_size": 128},
    }


def test_declip_with_bert_tower_trains_a_step(checkpoints):
    """declip_vitb32 with a Bert text tower: the MLM head sized by the HF
    vocabulary and width, one finite training step that moves the
    backbone."""
    from declip_tpu_torch.models import model_entry
    from declip_tpu_torch.models.memory_bank import init_bank
    from declip_tpu_torch.optim import optim_entry
    from declip_tpu_torch.train import make_train_step, new_train_state

    model = model_entry({"type": "declip_vitb32",
                         "kwargs": _declip_kwargs(checkpoints["bert"])})
    model.init_weights(torch.Generator().manual_seed(0))
    assert model.text_label_predictor.weight.shape == (100, 32)
    dense = model.encode_text.backbone.encoder.layer[0].output.dense
    before = dense.weight.clone()
    named = dict(model.named_parameters())
    tx = optim_entry({"type": "AdamW", "kwargs": {"lr": 1e-3}}, model,
                     lambda i: 1e-3)
    state = new_train_state(model=model, opt_state=tx.init(named),
                            bank_text=init_bank(torch.Generator(), 128, 64))
    step = make_train_step(model, tx, {}, lambda i: 1e-3)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(_tokens(0)).long()
    batch = {"images": torch.from_numpy(
                 rng.normal(size=(4, 32, 32, 6)).astype(np.float32)),
             "tokens": toks, "tokens_aug": toks.flip(1).contiguous(),
             "mlm_tokens": toks,
             "mlm_labels": torch.where(toks % 3 == 0, toks, -100)}
    state, metrics = step(state, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert not torch.equal(before, dense.weight)


def test_solver_init_hf_text_with_nn_bank(checkpoints, tmp_path):
    """The counterpart of tests/test_hf_text.py's: a Solver with a Bert
    text tower and the NN bank, whose width the solver reads from the
    model (``feature_dim``)."""
    from declip_tpu_torch.config import override, parse_config
    from declip_tpu_torch.solver import Solver

    shutil.copy(REPO + "/experiments/unit/tiny_clip/config.yaml",
                tmp_path / "config.yaml")
    cfg = parse_config(str(tmp_path / "config.yaml"))
    cfg = override(cfg, "model.type", "declip_vitb32")
    cfg = override(cfg, "model.kwargs.text_encode", {
        "text_encode_type": "Bert",
        "text_model_utils": {"pretrained_path": checkpoints["bert"]},
        "embed_dim": 64,
    })
    cfg = override(cfg, "model.kwargs.clip.return_nn_bank", True)
    cfg = override(cfg, "model.kwargs.clip.feature_dim", 64)
    cfg = override(cfg, "model.kwargs.clip.nn_size", 128)
    cfg = override(cfg, "lr_scheduler.kwargs.max_iter", 2)
    cfg = override(cfg, "data.test", [])
    cfg["_config_path"] = str(tmp_path / "config.yaml")
    solver = Solver(cfg, device="cpu")
    assert solver.state.bank_text is not None
    assert solver.state.bank_text.bank.shape == (128, 64)
    assert solver._feature_dim() == 64
    # the seeded init kept the pretrained backbone
    from transformers import BertModel

    ref = BertModel.from_pretrained(checkpoints["bert"]).state_dict()
    got = solver.model.encode_text.backbone.state_dict()
    assert all(torch.equal(got[k].cpu(), v) for k, v in ref.items())
