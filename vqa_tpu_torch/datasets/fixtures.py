"""Synthetic fixture generator, a copy of ``vqa_tpu/datasets/fixtures.py``
(the port imports nothing of the JAX package; tests/test_torch_fixtures.py
holds its files equal to the original's).

No network access is needed: every stage (prep, training, scoring) runs
against fabricated data in the raw schema of VQA v2, VQA v1, COCO-QA or
TDIUC, plus a bottom-up-style 36x2048 feature table. Deterministic per
(seed, sizes): the draws come from ``np.random.default_rng(seed)`` in the
original's order.

The data carries real signal: each image is assigned attribute latents
(color, count, object, presence) and its feature vector encodes them in
fixed dimensions, so models can learn and accuracy is meaningful.

The feature table goes to HDF5 (``features="hdf5"``, as the original writes
it: ``<dir>/coco/extract/bottomup36_{att,noatt}.h5``) or, with
``features="memory"``, into ``FeatureStore.in_memory`` stores placed where
the dataset factory looks for those files (``datasets.factory.place_store``),
for a machine without h5py; they live as long as the process.

CLI (HDF5):
  python -m vqa_tpu_torch.datasets.fixtures --dir /tmp/fix --n_images 64 --n_questions 256
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from vqa_tpu_torch.datasets.features import FeatureStore, write_features
from vqa_tpu_torch.datasets.interim import RAW_FILES_BY_DATASET, coco_split_for, image_name

NOUNS = ["cat", "dog", "car", "tree", "ball", "shirt", "house", "bird"]
COLORS = ["red", "blue", "green", "yellow", "black", "white"]
COUNTS = ["1", "2", "3", "4", "5"]
YESNO = ["yes", "no"]
ALL_ANSWERS = COLORS + COUNTS + YESNO + NOUNS

N_REGIONS = 36
DIM_FEAT = 2048
ARCH = "bottomup36"
SUBDIR = {"VQA2": "vqa2", "VQA": "vqa1", "COCOQA": "cocoqa", "TDIUC": "tdiuc"}
FEATURES = ("hdf5", "memory")


def _image_latents(rng: np.random.Generator) -> Dict[str, str]:
    return {
        "color": COLORS[rng.integers(len(COLORS))],
        "count": COUNTS[rng.integers(len(COUNTS))],
        "noun": NOUNS[rng.integers(len(NOUNS))],
        "present": YESNO[rng.integers(len(YESNO))],
    }


def _features_for(latents: Dict[str, str], rng: np.random.Generator) -> np.ndarray:
    """36x2048 features with latents linearly decodable from fixed dims."""
    feat = rng.standard_normal((N_REGIONS, DIM_FEAT)).astype(np.float32)
    # one-hot signal blocks, strong enough to dominate the noise
    offs = 0
    for key, space in (("color", COLORS), ("count", COUNTS), ("noun", NOUNS),
                       ("present", YESNO)):
        feat[:, offs + space.index(latents[key])] += 4.0
        offs += len(space)
    return feat


def _question_for(latents: Dict[str, str], kind: int) -> tuple:
    noun = latents["noun"]
    if kind == 0:
        return f"What color is the {noun}?", latents["color"]
    if kind == 1:
        return f"How many {noun}s are there?", latents["count"]
    if kind == 2:
        return f"Is there a {noun} in the picture?", latents["present"]
    return "What object is in the picture?", noun


def _write_lines(path: str, lines: Sequence[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def place_features(coco_dir: str, names: Sequence[str], features: np.ndarray) -> None:
    """The in-memory counterpart of the two ``write_features`` calls: the
    region table (att) and its mean over regions (noatt), each standing
    where the dataset factory would open ``<coco_dir>/extract/bottomup36_
    <mode>.h5``."""
    from vqa_tpu_torch.datasets.factory import place_store

    for mode, table in (("att", features), ("noatt", features.mean(axis=1))):
        place_store(coco_dir, ARCH, mode, FeatureStore.in_memory(list(names), table))


def generate(
    dir_out: str,
    n_images: int = 64,
    n_questions: int = 256,
    seed: int = 0,
    splits: tuple = ("train", "val", "test", "testdev"),
    dataset: str = "VQA2",
    features: str = "hdf5",
) -> None:
    """Write the raw files of ``dataset`` under ``<dir_out>/<subdir>/raw``
    and its feature table for ``<dir_out>/coco``: to HDF5, or with
    ``features="memory"`` into the dataset factory's store cache."""
    if features not in FEATURES:
        raise ValueError(f"features={features!r}: one of {FEATURES}")
    rng = np.random.default_rng(seed)
    dir_raw = os.path.join(dir_out, SUBDIR[dataset], "raw")
    os.makedirs(dir_raw, exist_ok=True)
    if dataset == "COCOQA":
        splits = tuple(s for s in splits if s in ("train", "val"))
    elif dataset != "VQA2":
        splits = tuple(s for s in splits if s in RAW_FILES_BY_DATASET[dataset])

    all_names: List[str] = []
    all_feats: List[np.ndarray] = []
    next_qid = 1
    for split_i, split in enumerate(splits):
        coco = coco_split_for(split)
        image_ids = [split_i * 10_000 + k for k in range(n_images)]
        latents = {}
        for iid in image_ids:
            lat = _image_latents(rng)
            latents[iid] = lat
            all_names.append(image_name(coco, iid))
            all_feats.append(_features_for(lat, rng))

        questions, annotations = [], []
        for _ in range(n_questions):
            iid = image_ids[rng.integers(n_images)]
            text, answer = _question_for(latents[iid], int(rng.integers(4)))
            qid = next_qid
            next_qid += 1
            questions.append({"image_id": iid, "question": text, "question_id": qid})
            # 10 annotators: mostly consensus, a couple of noisy answers
            anns = [answer] * int(rng.integers(8, 11))
            while len(anns) < 10:
                anns.append(ALL_ANSWERS[rng.integers(len(ALL_ANSWERS))])
            annotations.append({
                "image_id": iid,
                "question_id": qid,
                "question_type": "synthetic",
                "answer_type": "other",
                "multiple_choice_answer": answer,
                "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j + 1}
                            for j, a in enumerate(anns)],
            })

        if dataset == "COCOQA":
            base = os.path.join(dir_raw, "train" if split == "train" else "test")
            os.makedirs(base, exist_ok=True)
            _write_lines(os.path.join(base, "questions.txt"), [q["question"] for q in questions])
            _write_lines(os.path.join(base, "answers.txt"),
                         [a["multiple_choice_answer"] for a in annotations])
            _write_lines(os.path.join(base, "img_ids.txt"),
                         [str(q["image_id"]) for q in questions])
            _write_lines(os.path.join(base, "types.txt"), ["0" for _ in questions])
        else:
            qfile, afile = RAW_FILES_BY_DATASET[dataset][split]
            with open(os.path.join(dir_raw, qfile), "w") as f:
                json.dump({"questions": questions}, f)
            if afile is not None:
                with open(os.path.join(dir_raw, afile), "w") as f:
                    json.dump({"annotations": annotations}, f)

    coco_dir = os.path.join(dir_out, "coco")
    feats = np.stack(all_feats)
    if features == "memory":
        place_features(coco_dir, all_names, feats)
        return
    write_features(coco_dir, ARCH, "att", all_names, feats)
    write_features(coco_dir, ARCH, "noatt", all_names, feats.mean(axis=1))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir", required=True)
    p.add_argument("--n_images", type=int, default=64)
    p.add_argument("--n_questions", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset", default="VQA2", choices=list(SUBDIR))
    args = p.parse_args(argv)
    generate(args.dir, args.n_images, args.n_questions, args.seed, dataset=args.dataset)
    print(f"fixture written to {args.dir}")


if __name__ == "__main__":
    main()
