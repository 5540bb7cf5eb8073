"""CLIP text transformer tower (port of declip_tpu/models/text.py).

The 'Transformer' branch of prototype/model/text_encoder/text_transformer.py:
token embedding (std 0.02), learned positional embedding (std 0.01), causal
transformer, final LayerNorm, linear projection to the joint space. The
tower consumes token ids ([B, 77]), never strings.

EOT pooling selects the FIRST position equal to ``eot_id`` (default
``vocab_size - 1``, ``<|endoftext|>``), as the JAX package does, instead of
the reference's ``argmax(token_ids)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from declip_tpu_torch.models.layers import (
    LayerNorm,
    Transformer,
    as_dtype,
    dense,
    init_linear,
    linear,
    uninitialised,
)


class TextTransformer(nn.Module):
    """``scan_unroll`` is the JAX package's ``lax.scan`` unroll over depth,
    an XLA scheduling knob: accepted so that its configs build, unused.
    ``moe_*`` (text.py:48-53 of the JAX package): every block's MLP a
    :class:`~declip_tpu_torch.models.layers.MoeMlpBlock` (0: dense)."""

    def __init__(self, vocab_size: int, embed_dim: int = 1024,
                 context_length: int = 77, transformer_width: int = 512,
                 transformer_heads: int = 8, transformer_layers: int = 12,
                 positional_embedding_flag: bool = True,
                 checkpoint: bool = False, remat_policy: str = "policy",
                 scan_unroll: int = -1, eot_id: Optional[int] = None,
                 dtype=None, attn_impl: str = "auto", device=None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01):
        super().__init__()
        self.vocab_size = vocab_size
        self.width = transformer_width  # the token features' width
        self.dtype = dtype = as_dtype(dtype)
        self.moe_experts = moe_experts
        self.eot_id = eot_id if eot_id is not None else vocab_size - 1
        self.token_embedding = uninitialised(
            nn.Embedding, vocab_size, transformer_width, device=device)
        self.positional_embedding = (
            nn.Parameter(torch.empty(context_length, transformer_width,
                                     device=device))
            if positional_embedding_flag else None)
        self.transformer = Transformer(
            transformer_width, transformer_layers, transformer_heads,
            causal=True, attn_impl=attn_impl, dtype=dtype,
            checkpoint=checkpoint, remat_policy=remat_policy, device=device,
            moe_experts=moe_experts, moe_top_k=moe_top_k,
            moe_capacity_factor=moe_capacity_factor,
            moe_aux_weight=moe_aux_weight)
        self.ln_final = LayerNorm(transformer_width, dtype=dtype,
                                  device=device)
        self.text_projection = linear(transformer_width, embed_dim, device)

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX init stds (text.py:63-83, 109-115)."""
        width = self.ln_final.normalized_shape[0]
        nn.init.normal_(self.token_embedding.weight, std=0.02,
                        generator=generator)
        if self.positional_embedding is not None:
            nn.init.normal_(self.positional_embedding, std=0.01,
                            generator=generator)
        self.transformer.init_weights(generator)
        self.ln_final.reset_parameters()
        init_linear(self.text_projection, width ** -0.5, generator)

    def forward(self, tokens: torch.Tensor, return_dense: bool = False):
        """tokens: int [B, L] -> pooled [B, embed_dim]; with ``return_dense``
        also the ``ln_final`` token features [B, L, width] (text.py:104-120),
        as a tuple."""
        x = self.token_embedding(tokens).to(self.dtype)
        if self.positional_embedding is not None:
            x = x + self.positional_embedding[: x.shape[1]].to(x.dtype)
        x = self.ln_final(self.transformer(x))
        # first-eot pooling (see module docstring); argmax returns the first
        # maximum, and position 0 when a row has no eot (as jnp.argmax)
        eot_pos = (tokens == self.eot_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
        out = dense(pooled, self.text_projection.weight,
                    self.text_projection.bias, self.dtype)
        return (out, x) if return_dense else out


def text_transformers(**kwargs) -> TextTransformer:
    """Factory matching the reference defaults (text_transformer.py:273-288).

    Dispatches on ``text_encode_type``: 'Transformer' (the default) builds
    the CLIP tower; Bert/Bert_large/Roberta/Roberta_large/GPT2 build the
    HuggingFace tower (models/hf_text.py) from the local weights under
    ``text_model_utils.pretrained_path``."""
    kwargs = dict(kwargs)
    encode_type = kwargs.pop("text_encode_type", None) or "Transformer"
    kwargs.pop("bpe_path", None)
    utils = kwargs.pop("text_model_utils", None) or {}
    if encode_type != "Transformer":
        from declip_tpu_torch.models.hf_text import build_hf_text

        return build_hf_text(
            encode_type, embed_dim=kwargs.get("embed_dim", 1024),
            pretrained_path=utils.get("pretrained_path"),
            dtype=kwargs.get("dtype"), device=kwargs.get("device"))
    defaults = dict(
        context_length=77,
        transformer_width=512,
        transformer_heads=8,
        transformer_layers=12,
        positional_embedding_flag=True,
    )
    defaults.update(kwargs)
    return TextTransformer(**defaults)
