"""Question encoding for serving, a copy of the encode loop in
``vqa_tpu/datasets/processed.py`` (encode_question, encode_question_batch),
kept here for the same reason as tokenizer.py."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 1


def encode_question(
    tokens: Sequence[str],
    word_to_wid: Dict[str, int],
    maxlength: int,
    pad: str = "right",
) -> tuple:
    wids = [word_to_wid.get(w, UNK_ID) for w in tokens[:maxlength]]
    length = len(wids)
    padding = [PAD_ID] * (maxlength - length)
    row = wids + padding if pad == "right" else padding + wids
    return np.asarray(row, dtype=np.int32), length


def encode_question_batch(
    questions: Sequence[str],
    tokenizer,
    word_to_wid: Dict[str, int],
    maxlength: int,
    pad: str = "right",
) -> tuple:
    """Tokenize + encode raw questions into [N, maxlength] int32 ids and [N]
    lengths."""
    rows, lengths = [], []
    for q in questions:
        row, length = encode_question(tokenizer(q), word_to_wid, maxlength, pad)
        rows.append(row)
        lengths.append(length)
    return np.stack(rows), np.asarray(lengths, np.int32)
