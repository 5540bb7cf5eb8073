"""Vectorized BERT-style MLM masking for the text branch (the port's own
copy of declip_tpu/tokenizer/mlm.py).

Reference semantics (prototype/model/utils/text_utils/mask_tokens.py:5-29):
select 15% of non-special tokens; of those 80% become ``<|mask|>``, 10% become
a random vocab token, 10% stay; labels are -100 everywhere else. One
vectorized numpy pass over the whole batch, run on the host; the same numpy
generator gives the same masks as the JAX package's copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IGNORE_INDEX = -100


def mask_tokens(
    tokens: np.ndarray,
    *,
    mask_id: int,
    vocab_size: int,
    special_ids: Tuple[int, ...],
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (masked_tokens, labels), both shaped like ``tokens``.

    ``tokens`` is int [..., L]; padding (id 0) and ``special_ids`` are never
    masked. Labels are int64, -100 where nothing was selected.
    """
    tokens = np.asarray(tokens)
    special = tokens == 0
    for sid in special_ids:
        special |= tokens == sid

    probs = rng.random(tokens.shape)
    selected = (probs < mlm_probability) & ~special
    labels = np.where(selected, tokens, IGNORE_INDEX).astype(np.int64)

    # split the selected 15% into 80/10/10 with fresh draws
    action = rng.random(tokens.shape)
    to_mask = selected & (action < 0.8)
    to_random = selected & (action >= 0.8) & (action < 0.9)

    out = tokens.copy()
    out[to_mask] = mask_id
    if to_random.any():
        out[to_random] = rng.integers(0, vocab_size, size=int(to_random.sum()))
    return out, labels
