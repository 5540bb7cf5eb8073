from declip_tpu_torch.tokenizer.bpe import BpeTokenizer  # noqa: F401
from declip_tpu_torch.tokenizer.eda import EDA  # noqa: F401
from declip_tpu_torch.tokenizer.mlm import IGNORE_INDEX, mask_tokens  # noqa: F401

_default_tokenizer = None
_default_merges_path = None


def get_tokenizer(merges_path=None) -> BpeTokenizer:
    """Process-wide shared tokenizer (construction scans the merge table).

    An explicit ``merges_path`` becomes the process default: model building
    (config ``text_encode.bpe_path``) and serving must tokenize with the SAME
    vocab — if they diverged, the text tower's eot id would never appear in
    the token rows and EOT pooling would silently select position 0."""
    global _default_tokenizer, _default_merges_path
    if merges_path is not None and merges_path != _default_merges_path:
        _default_tokenizer = BpeTokenizer(merges_path)
        _default_merges_path = merges_path
    elif _default_tokenizer is None:
        _default_tokenizer = BpeTokenizer(None)
    return _default_tokenizer
