"""Question tokenizers, a copy of ``vqa_tpu/datasets/tokenizer.py``.

The original package's ``datasets`` imports h5py (for its feature store) as
soon as any of its modules is imported, and the GPU machine the port serves
on may not have h5py, so the serving path carries its own copy.
tests/test_torch_serve.py holds it equal to the original.
"""

from __future__ import annotations

import re
from typing import List

_REMOVE_RE = re.compile(r"[?!'\"$:@(),.;]")
_SEPARATE_RE = re.compile(r"[-/]")
_NON_ALNUM_RE = re.compile(r"[^a-z0-9 ]")


def tokenize_mcb(text: str) -> List[str]:
    """MCB/VQA-style tokenization: lowercase, drop punctuation, split."""
    t = text.lower()
    t = _REMOVE_RE.sub("", t)
    t = _SEPARATE_RE.sub(" ", t)
    return [w for w in t.split() if w]


def tokenize_naive(text: str) -> List[str]:
    """Lowercase, map every non-alphanumeric to space, split."""
    t = _NON_ALNUM_RE.sub(" ", text.lower())
    return [w for w in t.split() if w]


_TOKENIZERS = {
    "mcb": tokenize_mcb,
    "naive": tokenize_naive,
}


def get_tokenizer(name: str):
    try:
        return _TOKENIZERS[name]
    except KeyError:
        raise KeyError(f"unknown tokenizer {name!r}; known: {sorted(_TOKENIZERS)}") from None
