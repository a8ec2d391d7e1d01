"""Raw VQA json -> interim examples, a copy of ``vqa_tpu/datasets/interim.py``
(the port imports nothing of the JAX package; tests/test_torch_data.py holds
the port's prep equal to the original's).

Raw schema (official VQA v2 release):
  questions file:   {"questions": [{"image_id", "question", "question_id"}]}
  annotations file: {"annotations": [{"image_id", "question_id",
                     "multiple_choice_answer", "answer_type",
                     "answers": [{"answer", "answer_confidence", "answer_id"} x10]}]}

Interim example (one dict per question):
  {question_id, image_name, question, answer, answers}
where ``answer`` is the consensus (multiple_choice_answer) and ``answers`` the
10 annotator strings. Test splits have no annotation file -> answer fields
absent. VQA v1 and TDIUC use the same schemas under other file names; COCO-QA
ships line-aligned text files.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

_SPLIT_TO_COCO = {
    "train": "train2014",
    "val": "val2014",
    "test": "test2015",
    # test-dev is a *subset of test2015*: its question file carries the
    # test-dev2015 tag but the referenced images live in (and are named
    # after) the test2015 release
    "testdev": "test2015",
}

RAW_FILES = {
    "train": (
        "v2_OpenEnded_mscoco_train2014_questions.json",
        "v2_mscoco_train2014_annotations.json",
    ),
    "val": (
        "v2_OpenEnded_mscoco_val2014_questions.json",
        "v2_mscoco_val2014_annotations.json",
    ),
    "test": ("v2_OpenEnded_mscoco_test2015_questions.json", None),
    "testdev": ("v2_OpenEnded_mscoco_test-dev2015_questions.json", None),
}

# VQA v1 uses the same record schemas with unprefixed file names (C24)
RAW_FILES_VQA1 = {
    "train": (
        "OpenEnded_mscoco_train2014_questions.json",
        "mscoco_train2014_annotations.json",
    ),
    "val": (
        "OpenEnded_mscoco_val2014_questions.json",
        "mscoco_val2014_annotations.json",
    ),
    "test": ("OpenEnded_mscoco_test2015_questions.json", None),
    "testdev": ("OpenEnded_mscoco_test-dev2015_questions.json", None),
}

# TDIUC (C24) is distributed in the VQA v1 json format (train/val only; its
# val split is the evaluation split). Annotations carry a per-question
# ``question_type`` over 12 task categories, preserved into the interim
# records for per-type reporting.
RAW_FILES_TDIUC = {
    "train": (
        "OpenEnded_mscoco_train2014_questions.json",
        "mscoco_train2014_annotations.json",
    ),
    "val": (
        "OpenEnded_mscoco_val2014_questions.json",
        "mscoco_val2014_annotations.json",
    ),
}

RAW_FILES_BY_DATASET = {
    "VQA2": RAW_FILES,
    "VQA": RAW_FILES_VQA1,
    "TDIUC": RAW_FILES_TDIUC,
}


def image_name(coco_split: str, image_id: int) -> str:
    return f"COCO_{coco_split}_{image_id:012d}"


def coco_split_for(split: str) -> str:
    return _SPLIT_TO_COCO[split]


def build_interim_cocoqa(dir_raw: str, split: str) -> List[Dict[str, Any]]:
    """COCO-QA adapter (C24): the public release ships one line-aligned txt
    file each for questions / answers / image ids / types per split."""
    coco = coco_split_for("train" if split == "train" else "val")
    base = os.path.join(dir_raw, "train" if split == "train" else "test")

    def lines(name: str) -> List[str]:
        with open(os.path.join(base, name)) as f:
            return [l.strip() for l in f if l.strip()]

    questions = lines("questions.txt")
    answers = lines("answers.txt")
    img_ids = lines("img_ids.txt")
    examples = []
    for i, (q, a, iid) in enumerate(zip(questions, answers, img_ids)):
        examples.append(
            {
                "question_id": i + 1,
                "image_name": image_name(coco, int(iid)),
                "question": q,
                "answer": a,
                # single-annotator dataset: the pool is the one answer
                "answers": [a],
            }
        )
    return examples


def build_interim(
    dir_raw: str, split: str, dataset: str = "VQA2"
) -> List[Dict[str, Any]]:
    """Join the questions and annotations files into interim examples."""
    if dataset == "COCOQA":
        return build_interim_cocoqa(dir_raw, split)
    qfile, afile = RAW_FILES_BY_DATASET[dataset][split]
    with open(os.path.join(dir_raw, qfile)) as f:
        questions = json.load(f)["questions"]

    annotations: Optional[Dict[int, Dict[str, Any]]] = None
    if afile is not None:
        with open(os.path.join(dir_raw, afile)) as f:
            annotations = {a["question_id"]: a for a in json.load(f)["annotations"]}

    coco = coco_split_for(split)
    examples = []
    for q in questions:
        ex: Dict[str, Any] = {
            "question_id": q["question_id"],
            "image_name": image_name(coco, q["image_id"]),
            "question": q["question"],
        }
        if annotations is not None:
            ann = annotations[q["question_id"]]
            ex["answer"] = ann["multiple_choice_answer"]
            ex["answers"] = [a["answer"] for a in ann["answers"]]
            if "question_type" in ann:  # TDIUC's 12 task categories (C24)
                ex["question_type"] = ann["question_type"]
        examples.append(ex)
    return examples


def write_interim(examples: List[Dict[str, Any]], dir_interim: str, split: str) -> str:
    os.makedirs(dir_interim, exist_ok=True)
    path = os.path.join(dir_interim, f"{split}_interim.json")
    with open(path, "w") as f:
        json.dump(examples, f)
    return path
