"""Official VQA-accuracy scorer, a copy of ``vqa_tpu/scorer.py`` (the port
imports nothing of the JAX package; tests/test_torch_scorer.py runs every case
of tests/test_scorer.py against it).

Implements the published VQA evaluation metric (Antol et al.; the public
VQA evaluation algorithm this reference lineage vendors):

  acc(ans) = mean over the 10 leave-one-annotator-out subsets of
             min(#{matching answers among the other 9} / 3, 1)

with the official answer-normalization pipeline, table-driven and
golden-tested:

  1. punctuation handling (space-contextual strip; periods dropped unless
     decimal; commas dropped inside digit groups),
  2. number words -> digits, drop articles (a/an/the),
  3. contraction repair (aint -> ain't, ...).

Normalization applies to predicted answers always and to ground-truth
answer sets only when annotators disagree — matching the official scorer's
behavior exactly, since the metric is unforgiving.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, List, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're", "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

ARTICLES = {"a", "an", "the"}

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    # NOTE: the third positional arg is `count`, so only the first 32
    # (=re.UNICODE) periods are stripped — this reproduces the official VQA
    # eval code's exact behavior, quirk included (the metric is the contract)
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out: List[str] = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(answer: str) -> str:
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(answer))


def question_accuracy(pred: str, gt_answers: Sequence[str]) -> float:
    """Leave-one-out VQA accuracy for one question.

    Official quirk preserved: the whitespace-cleaned prediction AND ground
    truths are punctuation/digit/article-normalized ONLY when annotators
    disagree — with unanimous ground truth the raw strings must match."""
    pred = pred.replace("\n", " ").replace("\t", " ").strip()
    gts = [a.replace("\n", " ").replace("\t", " ").strip() for a in gt_answers]
    if len(set(gts)) > 1:
        gts = [process_digit_article(process_punctuation(a)) for a in gts]
        pred = process_digit_article(process_punctuation(pred))
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1 :]
        matching = sum(1 for other in others if other == pred)
        accs.append(min(1.0, matching / 3.0))
    return sum(accs) / len(accs) if accs else 0.0


def evaluate(
    results: Iterable[Dict[str, Any]],
    annotations: Iterable[Dict[str, Any]],
) -> Dict[str, Any]:
    """results: [{question_id, answer}]; annotations: official VQA v2 records.

    Returns {overall, per_answer_type, per_question_type, n} with accuracies
    in percent (matching the official report format).
    """
    ann_by_qid = {a["question_id"]: a for a in annotations}
    per_type: Dict[str, List[float]] = {}
    per_qtype: Dict[str, List[float]] = {}
    accs: List[float] = []
    for res in results:
        qid = res["question_id"]
        if qid not in ann_by_qid:
            raise KeyError(f"result question_id {qid} not in annotations")
        ann = ann_by_qid[qid]
        acc = question_accuracy(res["answer"], [a["answer"] for a in ann["answers"]])
        accs.append(acc)
        per_type.setdefault(ann.get("answer_type", "unknown"), []).append(acc)
        per_qtype.setdefault(ann.get("question_type", "unknown"), []).append(acc)

    def pct(xs: List[float]) -> float:
        return round(100.0 * sum(xs) / len(xs), 2) if xs else 0.0

    return {
        "overall": pct(accs),
        "per_answer_type": {k: pct(v) for k, v in sorted(per_type.items())},
        "per_question_type": {k: pct(v) for k, v in sorted(per_qtype.items())},
        "n": len(accs),
    }


def evaluate_files(results_path: str, annotations_path: str) -> Dict[str, Any]:
    with open(results_path) as f:
        results = json.load(f)
    with open(annotations_path) as f:
        annotations = json.load(f)["annotations"]
    return evaluate(results, annotations)
