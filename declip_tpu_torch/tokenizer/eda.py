"""EDA text augmentation, host-side, for DeCLIP's text self-supervision
(the port's copy of declip_tpu/tokenizer/eda.py, with its own copy of the
synonym table in ``tokenizer/data/synonyms.json``).

The reference calls ``textaugment.EDA`` per caption *inside the model forward*
(prototype/model/declip.py:203-212) — a Python loop on the training critical
path. Here EDA runs in the data pipeline on raw strings before tokenization,
so the device never waits on it.

Per caption the reference picks uniformly among synonym-replacement /
random-swap / random-deletion. Synonym replacement uses WordNet when the
nltk corpus is present; hermetic environments fall back to the bundled
static synonym table (data/synonyms.json, ~600 caption-vocabulary entries
after symmetric closure) so all three ops always run — matching the
reference recipe's op distribution (declip.py:203-212). A user-supplied
table overrides both.
"""

from __future__ import annotations

import json
import os.path as osp
import random
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

@lru_cache(maxsize=1)
def _wordnet():
    """nltk's WordNet reader when nltk and its corpus are installed, else
    None. Probed on first use, not at import: importing nltk takes seconds,
    and every spawned loader worker imports this module."""
    try:
        from nltk.corpus import wordnet
    except ImportError:
        return None
    try:  # corpus present?
        wordnet.synsets("test")
    except LookupError:
        return None
    return wordnet


@lru_cache(maxsize=1)
def default_synonym_table() -> Dict[str, List[str]]:
    """Bundled static table with symmetric closure (if a->b then b->a).
    Keys ending in a digit are disambiguation aliases for duplicate JSON
    keys (e.g. 'watch2' the noun vs 'watch' the verb) — folded back here."""
    path = osp.join(osp.dirname(osp.abspath(__file__)), "data",
                    "synonyms.json")
    with open(path) as f:
        raw = json.load(f)
    table: Dict[str, set] = {}
    for key, syns in raw.items():
        word = key.rstrip("0123456789")
        table.setdefault(word, set()).update(syns)
        for s in syns:
            table.setdefault(s, set()).add(word)
    return {w: sorted(s - {w}) for w, s in table.items() if s - {w}}


def random_swap(words: List[str], n: int, rng: random.Random) -> List[str]:
    words = list(words)
    for _ in range(n):
        if len(words) < 2:
            break
        i, j = rng.sample(range(len(words)), 2)
        words[i], words[j] = words[j], words[i]
    return words


def random_deletion(words: List[str], p: float, rng: random.Random) -> List[str]:
    if len(words) <= 1:
        return list(words)
    kept = [w for w in words if rng.random() > p]
    return kept if kept else [rng.choice(words)]


def _synonyms(word: str, table: Optional[Dict[str, Sequence[str]]]):
    if table is not None:
        return list(table.get(word, ()))
    wn = _wordnet()
    if wn is not None:
        syns = {
            lemma.name().replace("_", " ")
            for ss in wn.synsets(word)
            for lemma in ss.lemmas()
        }
        syns.discard(word)
        return sorted(syns)
    return list(default_synonym_table().get(word.lower(), ()))


def synonym_replacement(
    words: List[str],
    n: int,
    rng: random.Random,
    table: Optional[Dict[str, Sequence[str]]] = None,
) -> List[str]:
    words = list(words)
    candidates = [i for i, w in enumerate(words) if w.isalpha()]
    rng.shuffle(candidates)
    replaced = 0
    for i in candidates:
        syns = _synonyms(words[i], table)
        if syns:
            words[i] = rng.choice(syns)
            replaced += 1
        if replaced >= n:
            break
    return words


class EDA:
    """Easy Data Augmentation over captions.

    ``augment(caption)`` applies one randomly chosen op, mirroring the
    reference's random.choice among sr/swap/delete (declip.py:205-211).
    """

    def __init__(
        self,
        seed: Optional[int] = None,
        p_delete: float = 0.1,
        n_ops: int = 1,
        synonym_table: Optional[Dict[str, Sequence[str]]] = None,
    ):
        self.rng = random.Random(seed)
        self.p_delete = p_delete
        self.n_ops = n_ops
        self.synonym_table = synonym_table

    def augment(self, caption: str) -> str:
        words = caption.split()
        if not words:
            return caption
        # all three ops always available: WordNet when present, else the
        # bundled static table (the reference draws uniformly over all
        # three, declip.py:205-211)
        op = self.rng.choice(["synonym", "swap", "delete"])
        if op == "synonym":
            words = synonym_replacement(
                words, self.n_ops, self.rng, self.synonym_table
            )
        elif op == "swap":
            words = random_swap(words, self.n_ops, self.rng)
        else:
            words = random_deletion(words, self.p_delete, self.rng)
        return " ".join(words)

    def augment_batch(self, captions: Sequence[str]) -> List[str]:
        return [self.augment(c) for c in captions]
