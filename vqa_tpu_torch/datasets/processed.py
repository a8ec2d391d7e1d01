"""Interim -> processed artifacts, a copy of ``vqa_tpu/datasets/processed.py``
(the port imports nothing of the JAX package): the port's own data prep
(``run_prep``: raw -> interim -> processed), the artifacts' readers and the
question encoding serving uses. ``datasets/factory.py`` runs the prep on
first use. tests/test_torch_data.py holds the artifacts equal to the JAX
prep's on the same raw files (vocab.json byte for byte, each split's arrays
by value, dtype and shape).

Processing emits dense numpy arrays (npz), so batch assembly is fancy
indexing on the host. Artifacts per prep run (directory named from the knobs
that shape them):
  vocab.json            wid_to_word / aid_to_ans tables
  <split>.npz           question_ids, questions [N, maxlength] int32,
                        lengths, image_names, answers, answer_pool [N, 10]

Semantics, as the original's:
  * answer vocab = top-``nans`` consensus answers by train-split count;
  * word vocab from train questions, count > ``minwcount``, UNK for the rest;
  * questions encoded + padded (right/left per ``pad``) to ``maxlength``;
  * train examples whose consensus answer is out-of-vocab are dropped;
  * ``answer_pool`` holds the 10 annotator answers as aids (-1 where OOV),
    feeding train-time answer sampling (``samplingans``).

The original encodes mcb questions with its native C++ encoder where it is
built (``vqa_tpu/native/``, byte-identical to the Python path); the port
encodes with the Python tokenizer only.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vqa_tpu_torch.config import VQAOptions
from vqa_tpu_torch.datasets.tokenizer import get_tokenizer

PAD_ID = 0
UNK_ID = 1
PAD_WORD = "<pad>"
UNK_WORD = "<unk>"
N_ANNOTATORS = 10


@dataclasses.dataclass
class Vocabs:
    wid_to_word: List[str]   # [0]=<pad>, [1]=<unk>
    aid_to_ans: List[str]

    @property
    def word_to_wid(self) -> Dict[str, int]:
        if not hasattr(self, "_word_to_wid"):
            self._word_to_wid = {w: i for i, w in enumerate(self.wid_to_word)}
        return self._word_to_wid

    @property
    def ans_to_aid(self) -> Dict[str, int]:
        if not hasattr(self, "_ans_to_aid"):
            self._ans_to_aid = {a: i for i, a in enumerate(self.aid_to_ans)}
        return self._ans_to_aid

    @property
    def num_words(self) -> int:
        return len(self.wid_to_word)

    @property
    def num_answers(self) -> int:
        return len(self.aid_to_ans)


@dataclasses.dataclass
class ProcessedSplit:
    question_ids: np.ndarray           # int64 [N]
    questions: np.ndarray              # int32 [N, maxlength]
    lengths: np.ndarray                # int32 [N]
    image_names: np.ndarray            # unicode [N]
    answers: Optional[np.ndarray]      # int32 [N] (consensus aid), None for test
    answer_pool: Optional[np.ndarray]  # int32 [N, 10] (-1 pad), None for test

    def __len__(self) -> int:
        return len(self.question_ids)


def _sorted_by_count(counter: collections.Counter) -> List[str]:
    """Deterministic order: count desc, then lexicographic."""
    return [k for k, _ in sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))]


def build_answer_vocab(train_examples: Sequence[Dict[str, Any]], nans: int) -> List[str]:
    counts = collections.Counter(ex["answer"] for ex in train_examples)
    return _sorted_by_count(counts)[:nans]


def build_word_vocab(
    train_examples: Sequence[Dict[str, Any]], nlp: str, minwcount: int
) -> List[str]:
    tok = get_tokenizer(nlp)
    counts = collections.Counter()
    for ex in train_examples:
        counts.update(tok(ex["question"]))
    kept = [w for w in _sorted_by_count(counts) if counts[w] > minwcount]
    return [PAD_WORD, UNK_WORD] + kept


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


def encode_split(
    examples: Sequence[Dict[str, Any]],
    vocabs: Vocabs,
    opt: VQAOptions,
    is_train: bool,
) -> ProcessedSplit:
    tok = get_tokenizer(opt.nlp)
    word_to_wid = vocabs.word_to_wid
    ans_to_aid = vocabs.ans_to_aid
    has_answers = bool(examples) and "answer" in examples[0]

    if is_train and has_answers:
        examples = [ex for ex in examples if ex["answer"] in ans_to_aid]

    n = len(examples)
    question_ids = np.empty(n, dtype=np.int64)
    questions = np.empty((n, opt.maxlength), dtype=np.int32)
    lengths = np.empty(n, dtype=np.int32)
    image_names = np.empty(n, dtype=object)
    answers = np.full(n, -1, dtype=np.int32) if has_answers else None
    answer_pool = (
        np.full((n, N_ANNOTATORS), -1, dtype=np.int32) if has_answers else None
    )
    for i, ex in enumerate(examples):
        question_ids[i] = ex["question_id"]
        questions[i], lengths[i] = encode_question(
            tok(ex["question"]), word_to_wid, opt.maxlength, opt.pad
        )
        image_names[i] = ex["image_name"]
        if has_answers:
            answers[i] = ans_to_aid.get(ex["answer"], -1)
            for j, ans in enumerate(ex.get("answers", [])[:N_ANNOTATORS]):
                answer_pool[i, j] = ans_to_aid.get(ans, -1)

    return ProcessedSplit(
        question_ids=question_ids,
        questions=questions,
        lengths=lengths,
        image_names=image_names.astype(np.str_),
        answers=answers,
        answer_pool=answer_pool,
    )


# --------------------------------------------------------------------------
# persistence
# --------------------------------------------------------------------------


# bump when the artifact SEMANTICS change (not just knobs), so stale caches
# from older code never get silently reused; v2: eval splits keep OOV rows.
# The same as the JAX package's, so either package reads the other's files.
PREP_VERSION = 2


def processed_dir(dir_vqa: str, opt: VQAOptions) -> str:
    tag = (
        f"v{PREP_VERSION}_nans{opt.nans}_maxlen{opt.maxlength}_minw{opt.minwcount}"
        f"_{opt.nlp}_pad{opt.pad}_{opt.trainsplit}"
    )
    if opt.augment_dir:
        tag += "_aug"
    return os.path.join(dir_vqa, "processed", tag)


def save_vocabs(vocabs: Vocabs, dir_out: str) -> None:
    os.makedirs(dir_out, exist_ok=True)
    with open(os.path.join(dir_out, "vocab.json"), "w") as f:
        json.dump(
            {"wid_to_word": vocabs.wid_to_word, "aid_to_ans": vocabs.aid_to_ans}, f
        )


def load_vocabs(dir_out: str) -> Vocabs:
    with open(os.path.join(dir_out, "vocab.json")) as f:
        data = json.load(f)
    return Vocabs(wid_to_word=data["wid_to_word"], aid_to_ans=data["aid_to_ans"])


def save_split(split: ProcessedSplit, dir_out: str, name: str) -> None:
    os.makedirs(dir_out, exist_ok=True)
    arrays = {
        "question_ids": split.question_ids,
        "questions": split.questions,
        "lengths": split.lengths,
        "image_names": split.image_names,
    }
    if split.answers is not None:
        arrays["answers"] = split.answers
        arrays["answer_pool"] = split.answer_pool
    np.savez_compressed(os.path.join(dir_out, f"{name}.npz"), **arrays)


def load_split(dir_out: str, name: str) -> ProcessedSplit:
    with np.load(os.path.join(dir_out, f"{name}.npz"), allow_pickle=False) as data:
        return ProcessedSplit(
            question_ids=data["question_ids"],
            questions=data["questions"],
            lengths=data["lengths"],
            image_names=data["image_names"],
            answers=data["answers"] if "answers" in data else None,
            answer_pool=data["answer_pool"] if "answer_pool" in data else None,
        )


def run_prep(dir_vqa: str, opt: VQAOptions, splits: Sequence[str] = ("train", "val")) -> str:
    """Full first-run pipeline: raw -> interim -> processed.

    ``trainsplit='trainval'`` merges train+val examples for vocab building and
    training while still emitting a separate val file.
    """
    from vqa_tpu_torch.datasets.interim import build_interim, write_interim

    dir_raw = os.path.join(dir_vqa, "raw")
    dir_interim = os.path.join(dir_vqa, "interim")
    dir_out = processed_dir(dir_vqa, opt)

    required = {"train"} | ({"val"} if opt.trainsplit == "trainval" else set())
    missing = required - set(splits)
    if missing:
        raise FileNotFoundError(
            f"raw VQA files for split(s) {sorted(missing)} not found under {dir_raw}; "
            "point vqa.dir at real data or generate a fixture with "
            "`python -m vqa_tpu.datasets.fixtures --dir <dir>`"
        )

    interim = {}
    for split in splits:
        interim[split] = build_interim(dir_raw, split, dataset=opt.dataset)
        write_interim(interim[split], dir_interim, split)

    if opt.trainsplit == "trainval":
        train_examples = interim["train"] + interim.get("val", [])
    else:
        train_examples = interim[opt.trainsplit]

    if opt.augment_dir:
        # Visual-Genome-style QA augmentation: extra single-answer train
        # pairs [{image_name, question, answer}], merged into the train split
        # only (never into eval splits).
        with open(os.path.join(opt.augment_dir, "vg_qa.json")) as f:
            extra = json.load(f)
        base_qid = 10_000_000  # clear of real VQA question-id space
        augment = [
            {
                "question_id": base_qid + i,
                "image_name": ex["image_name"],
                "question": ex["question"],
                "answer": ex["answer"],
                "answers": [ex["answer"]],
            }
            for i, ex in enumerate(extra)
        ]
        train_examples = list(train_examples) + augment

    vocabs = Vocabs(
        wid_to_word=build_word_vocab(train_examples, opt.nlp, opt.minwcount),
        aid_to_ans=build_answer_vocab(train_examples, opt.nans),
    )
    save_vocabs(vocabs, dir_out)

    for split in splits:
        # eval splits keep every row (OOV consensus marked -1, never dropped);
        # only the split actually used for training applies the OOV drop —
        # for trainsplit='trainval' that's the merged file written below
        is_train = split == "train"
        examples = interim[split]
        if split == "train" and opt.trainsplit == "train":
            examples = train_examples  # includes augmentation when enabled
        save_split(encode_split(examples, vocabs, opt, is_train), dir_out, split)
    if opt.trainsplit == "trainval":
        save_split(
            encode_split(train_examples, vocabs, opt, is_train=True), dir_out, "trainval"
        )
    return dir_out
