"""The read side of ``vqa_tpu/datasets/processed.py``, copied: question
encoding for serving (encode_question, encode_question_batch), and the
processed artifacts a run reads (processed_dir, Vocabs, load_vocabs), kept
here for the same reason as tokenizer.py. Data prep (``run_prep``: raw ->
interim -> processed) is not ported: the JAX package writes these files."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from vqa_tpu_torch.config import VQAOptions

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


# the JAX package's PREP_VERSION: the artifact semantics this reader expects
PREP_VERSION = 2


def processed_dir(dir_vqa: str, opt: VQAOptions) -> str:
    tag = (
        f"v{PREP_VERSION}_nans{opt.nans}_maxlen{opt.maxlength}_minw{opt.minwcount}"
        f"_{opt.nlp}_pad{opt.pad}_{opt.trainsplit}"
    )
    if opt.augment_dir:
        tag += "_aug"
    return os.path.join(dir_vqa, "processed", tag)


@dataclasses.dataclass
class Vocabs:
    wid_to_word: List[str]   # [0]=<pad>, [1]=<unk>
    aid_to_ans: List[str]

    @property
    def word_to_wid(self) -> Dict[str, int]:
        return {w: i for i, w in enumerate(self.wid_to_word)}

    @property
    def num_words(self) -> int:
        return len(self.wid_to_word)

    @property
    def num_answers(self) -> int:
        return len(self.aid_to_ans)


def load_vocabs(dir_out: str) -> Vocabs:
    with open(os.path.join(dir_out, "vocab.json")) as f:
        data = json.load(f)
    return Vocabs(wid_to_word=data["wid_to_word"], aid_to_ans=data["aid_to_ans"])


def processed_split(opt, split: str) -> str:
    """The directory of ``split``'s processed artifacts under ``opt.vqa``;
    raises FileNotFoundError when the JAX package's prep has not written
    them (the port does not run data prep)."""
    dir_proc = processed_dir(opt.vqa.dir, opt.vqa)
    for name in (f"{split}.npz", "vocab.json"):
        if not os.path.exists(os.path.join(dir_proc, name)):
            raise FileNotFoundError(
                f"{os.path.join(dir_proc, name)} not found: the port reads processed VQA "
                "data and does not prepare it; run the JAX package's prep first "
                "(vqa_tpu.datasets.processed.run_prep, which vqa_tpu.datasets.factory runs "
                "on first use)"
            )
    return dir_proc
