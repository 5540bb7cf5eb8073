"""HuggingFace text towers: Bert, Bert_large, Roberta, Roberta_large and
GPT2 (port of declip_tpu/models/hf_text.py).

Rebuilds the non-'Transformer' branches of prototype/model/text_encoder/
text_transformer.py:46-107, which load pretrained HF models from local
paths. The backbone is transformers' torch model,
``AutoModel.from_pretrained(path, local_files_only=True)``: the same
library whose Flax models the JAX package wraps. Nothing is downloaded; a
missing directory raises ``FileNotFoundError``, and without ``transformers``
building such a tower raises ``ImportError``. There is no fallback tower.

The backbone holds the pretrained weights from construction, so the
model's seeded ``init_weights`` initialises only the projection (flax's
Dense init), and the JAX solver's graft of the pretrained weights into its
initialised variables (declip_tpu/solver/__init__.py:400-405) has nothing
left to do here. A checkpoint or carried JAX variables
(``convert.state_from_jax_variables``, the ``text/backbone`` subtree)
overwrite them with ``load_state_dict``.

Pooling is the reference's: the CLS token for Bert and Roberta, the mean
over non-pad tokens for GPT2 (``max(count, 1)`` in the denominator;
text_transformer.py:255-262), then a linear projection to the joint
embedding dim. The pad id comes from the HF config (Roberta pads with 1),
and the attention mask is ``tokens != pad_id``. GPT2 gets explicit
``position_ids``, as the JAX package gives its Flax module; Bert counts
positions from 0 and Roberta from its pad id, as transformers' torch models
do by themselves. The JAX package calls the bare Flax module, which counts
Roberta's positions from 0 too; the reference's torch Roberta does not, and
the port follows the reference there (ROADMAP.md §3).

The parameters stay fp32. With a ``dtype`` other than float32 the backbone
runs under ``torch.autocast`` in that dtype: its matmuls in the dtype, its
normalisations and softmax in fp32, as autocast does (the Flax modules run
their softmax in the dtype too); the token features are returned in the
dtype and the projection computes in it.

Attention inside these towers is transformers' own (its ``sdpa`` path, or
what the checkpoint's config names). The JAX package runs it in Flax,
outside any Pallas kernel, and K1 has no key-padding mask, so it is no TPU
kernel left unported here.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from declip_tpu_torch.models.layers import (
    as_dtype,
    dense,
    lecun_normal_,
    linear,
)


def _auto_model():
    try:
        from transformers import AutoModel
    except ImportError as e:
        raise ImportError(
            "the HuggingFace text towers (text_encode_type Bert, "
            "Bert_large, Roberta, Roberta_large, GPT2) need the "
            "'transformers' package, which is not importable here") from e
    return AutoModel


class HFTextEncoder(nn.Module):
    """An HF backbone and a projection; consumes token ids ``[B, L]``."""

    def __init__(self, text_encode_type: str, pretrained_path: str,
                 embed_dim: int = 1024, dtype=None, device=None):
        super().__init__()
        if not os.path.isdir(pretrained_path):
            raise FileNotFoundError(
                f"HF weights not found at {pretrained_path!r} — the "
                f"'{text_encode_type}' text tower needs local "
                "pretrained files (zero-egress environments cannot download).")
        self.dtype = as_dtype(dtype)
        self.backbone = _auto_model().from_pretrained(
            pretrained_path, local_files_only=True)
        if device is not None:
            self.backbone.to(device)
        hf_config = self.backbone.config
        self.width = int(hf_config.hidden_size)
        self.text_projection = linear(self.width, embed_dim, device)
        # the real tokenizer vocab (MLM head sizing); the pad id for masking
        self.vocab_size = int(getattr(hf_config, "vocab_size", 30522))
        self.pad_id = int(getattr(hf_config, "pad_token_id", 0) or 0)
        self.cls_pooling = text_encode_type.startswith(("Bert", "Roberta"))
        self.takes_position_ids = hf_config.model_type == "gpt2"

    def train(self, mode: bool = True):
        """The backbone stays in eval mode (no dropout): the JAX package
        calls its Flax module deterministic, in training too."""
        super().train(mode)
        self.backbone.eval()
        return self

    def init_weights(self, generator: torch.Generator) -> None:
        """The projection only (flax's Dense init: lecun normal, zero
        bias); the backbone keeps its pretrained weights."""
        lecun_normal_(self.text_projection.weight, generator)
        nn.init.zeros_(self.text_projection.bias)

    def forward(self, tokens: torch.Tensor, return_dense: bool = False):
        """tokens: int [B, L] -> pooled [B, embed_dim]; with
        ``return_dense`` also the backbone's last hidden states
        [B, L, width], as a tuple."""
        attn = (tokens != self.pad_id).long()
        kwargs = {"input_ids": tokens.long(), "attention_mask": attn}
        if self.takes_position_ids:
            b, length = tokens.shape
            kwargs["position_ids"] = torch.arange(
                length, device=tokens.device).expand(b, length)
        with torch.autocast(tokens.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            words = self.backbone(**kwargs).last_hidden_state
        words = words.to(self.dtype)
        if self.cls_pooling:
            pooled = words[:, 0, :]
        else:  # GPT2: mean over the non-pad tokens
            mask = attn.to(words.dtype)[..., None]
            denom = torch.clamp(attn.sum(-1, keepdim=True), min=1)
            pooled = (words * mask).sum(1) / denom.to(words.dtype)
        pooled = dense(pooled, self.text_projection.weight,
                       self.text_projection.bias, self.dtype)
        return (pooled, words) if return_dense else pooled


def build_hf_text(text_encode_type: str, embed_dim: int,
                  pretrained_path: Optional[str] = None, dtype=None,
                  device=None) -> HFTextEncoder:
    """The tower from ``pretrained_path``, or from ``DECLIP_HF_TEXT_PATH``
    where none is given."""
    path = pretrained_path or os.environ.get("DECLIP_HF_TEXT_PATH", "")
    return HFTextEncoder(text_encode_type, path, embed_dim=embed_dim,
                         dtype=dtype, device=device)
