"""Byte-level BPE tokenizer (CLIP-compatible) with an added ``<|mask|>`` token.

The port's own copy of declip_tpu/tokenizer/bpe.py (the two packages must
produce the same ids for the same text, and the same text for the same ids;
tests/test_torch_host.py and tests/test_torch_tools_extra.py check it).

Implements the public CLIP BPE scheme the reference uses
(prototype/model/utils/text_utils/simple_tokenizer.py): a reversible
byte->unicode alphabet, end-of-word ``</w>`` marker, greedy lowest-rank pair
merging, and the CLIP word-split regex. The reference extends the standard
49408-entry vocab with ``<|mask|>`` for MLM (simple_tokenizer.py:73) giving
vocab 49409; we do the same.

The merges file (``bpe_simple_vocab_16e6.txt.gz``) is *data* the user supplies
— it is not shipped in the reference tree either (its ``default_bpe()`` points
at a file that must exist at runtime). When no merges file is found we build a
merge-free byte-level vocab (every word becomes character tokens); this keeps
the whole framework hermetically testable. Token *ids* then differ from CLIP's
but every structural property (mask/sot/eot as the last three ids,
padding, truncation, MLM) is identical.

Tokenization is host-side and happens in the data pipeline, never inside
the model (the reference tokenizes inside ``encode_text`` on CPU
every step — text_transformer.py:185-188 — which we deliberately fix).
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

try:
    import regex as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|<\|mask\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is expected in the image
    import re as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|<\|mask\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\s a-z0-9]+""",
        _re.IGNORECASE,
    )

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False


@lru_cache()
def byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map (standard byte-level BPE)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    chars = keep[:]
    n = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(keep, (chr(c) for c in chars)))


def clean_text(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


def _pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


def default_merges_path() -> Optional[str]:
    """Locate a merges file: $DECLIP_BPE_PATH, package dir, or None."""
    env = os.environ.get("DECLIP_BPE_PATH")
    if env and os.path.exists(env):
        return env
    here = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")
    if os.path.exists(here):
        return here
    return None


class BpeTokenizer:
    """CLIP byte-level BPE with ``<|mask|>``.

    The vocab is [256 byte chars] + [256 byte chars + '</w>'] + [one token
    per merge] + ['<|mask|>', '<|startoftext|>', '<|endoftext|>'], so with the
    full CLIP merge table vocab_size == 49409 and <|endoftext|> is the highest
    id, matching the reference exactly (simple_tokenizer.py:69-74).
    """

    def __init__(self, merges_path: Optional[str] = None):
        if merges_path is None:
            merges_path = default_merges_path()
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges: List[Tuple[str, str]] = []
        if merges_path is not None:
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # standard file: first line is a version header; CLIP uses
            # entries 1..49152-256-2+1
            for line in lines[1 : 49152 - 256 - 2 + 1]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)  # type: ignore[arg-type]

        alphabet = list(self.byte_encoder.values())
        vocab = alphabet + [c + "</w>" for c in alphabet]
        vocab += ["".join(m) for m in merges]
        # reference order (simple_tokenizer.py:71-80): mask BEFORE sot/eot,
        # so <|endoftext|> is the highest id in the vocab
        vocab += ["<|mask|>", "<|startoftext|>", "<|endoftext|>"]

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
            "<|mask|>": "<|mask|>",
        }

    # --- vocab properties -------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_id(self) -> int:
        return self.encoder["<|endoftext|>"]

    @property
    def mask_id(self) -> int:
        return self.encoder["<|mask|>"]

    # --- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    merged.append(a + b)
                    i = j + 2
                else:
                    merged.append(word[j])
                    i = j + 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = clean_text(text).lower()
        for tok in _WORD_PAT.findall(text):
            if tok in ("<|startoftext|>", "<|endoftext|>", "<|mask|>"):
                ids.append(self.encoder[tok])
                continue
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(btok).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        """Text of ``ids``: the pieces joined and mapped back to bytes, the
        bytes decoded as UTF-8 with invalid sequences replaced, each
        ``</w>`` made a space. A special token comes out as its name
        (``<|endoftext|>``), as in the JAX package."""
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace(
            "</w>", " ").strip()

    # --- batch tokenization ----------------------------------------------
    def tokenize(
        self,
        texts: Sequence[str] | str,
        context_length: int = 77,
    ) -> np.ndarray:
        """Pad/truncate to ``[N, context_length]`` int32 with sot/eot.

        Matches the reference contract (text_transformer.py:144-180): truncate
        body to context_length-2, always terminate with eot, zero-pad.
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for r, text in enumerate(texts):
            body = self.encode(text)[: context_length - 2]
            row = [self.sot_id] + body + [self.eot_id]
            out[r, : len(row)] = row
        return out
