"""The one generator of the benchmark's traffic, driven by a traffic file.

A split is questions over images, in image order (every image holds at
least ``min_per_image`` questions, the rest spread over the images at
random), as VQA v2's splits are. Question lengths are drawn by the file
``lengths/<length.kind>.py`` (``normal``, ``uniform``, ``histogram``; a new
kind is a new file). The set of lengths and the questions each image
holds are drawn once from the traffic file's own ``draw_seed``, so every
run seed gets the same work; the run seed permutes the lengths over the
questions and draws the words, the answers (the consensus answer and ten
annotators' answers, a share of them out of the vocabulary) and the
feature table.

The table is the file ``tables/<table.kind>.py``'s. Its dense rows are
made here, on the card, in chunks of ``table.chunk`` images
(``CHUNK`` by default), each from a generator seeded by (seed, chunk): an
image's rows are a pure function of (seed, image index), so ``image_rows``
rebuilds any of them without the table, and each rank of a row-sharded
table makes its own rows alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench import plugins
from portbench.reference.params import DATA, TABLE, derive

CHUNK = 1024


def table_dtype(traffic: dict) -> torch.dtype:
    """``table.dtype``, a torch dtype's name (``bfloat16``, ``float16``,
    ``float32``, ...)."""
    dtype = getattr(torch, traffic["table"]["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"table.dtype {traffic['table']['dtype']!r} is no torch dtype")
    return dtype


def lengths_and_images(traffic: dict) -> tuple:
    """(lengths int32 [N], image of each question int32 [N]) before the
    run seed permutes the lengths: fixed by the traffic file."""
    split, ln = traffic["split"], traffic["length"]
    n, images = split["questions"], split["images"]
    rng = np.random.default_rng(ln["draw_seed"])
    lengths = plugins.load("lengths", ln["kind"]).draw(ln, n, rng)
    base = split["min_per_image"]
    extra = rng.multinomial(n - base * images, np.full(images, 1.0 / images))
    image = np.repeat(np.arange(images, dtype=np.int32), base + extra)
    return lengths, image


def generate(traffic: dict, num_words: int, num_answers: int, seed: int) -> Dict[str, np.ndarray]:
    """The split's host arrays for run ``seed``: ``question_ids`` (the row
    number), ``questions`` int32 [N, maxlength] right-padded with 0,
    ``lengths``, ``image_index``, ``answers`` int32 [N] and ``answer_pool``
    int32 [N, pool] (-1 for an answer out of the vocabulary)."""
    lengths, image = lengths_and_images(traffic)
    rng = np.random.default_rng(derive(seed, DATA))
    lengths = lengths[rng.permutation(len(lengths))]
    n, maxlength = len(lengths), traffic["maxlength"]
    questions = rng.integers(1, num_words, (n, maxlength), dtype=np.int32)
    questions *= (np.arange(maxlength)[None, :] < lengths[:, None]).astype(np.int32)
    pool = rng.integers(0, num_answers, (n, traffic["answer_pool"]), dtype=np.int32)
    pool[rng.random(pool.shape) < traffic["oov_share"]] = -1
    answers = np.where(pool[:, 0] >= 0, pool[:, 0],
                       rng.integers(0, num_answers, n, dtype=np.int32)).astype(np.int32)
    return {"question_ids": np.arange(n, dtype=np.int64), "questions": questions,
            "lengths": lengths, "image_index": image, "answers": answers, "answer_pool": pool}


def _chunk_size(traffic: dict) -> int:
    return traffic["table"].get("chunk", CHUNK)


def _chunk(seed: int, c: int, rows: int, traffic: dict, device) -> torch.Tensor:
    t = traffic["table"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, TABLE, c))
    out = torch.empty((rows, t["regions"], t["dim"]), dtype=table_dtype(traffic), device=device)
    return out.normal_(generator=gen)


def make_table(traffic: dict, seed: int, device) -> torch.Tensor:
    """The feature table [images, regions, dim] on ``device``."""
    return image_rows(traffic, seed, np.arange(traffic["split"]["images"]), device)


def image_rows(traffic: dict, seed: int, indices: np.ndarray, device,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The table's rows of the images ``indices``, made chunk by chunk (into
    ``out`` where given: a row-shard's first rows)."""
    images, chunk = traffic["split"]["images"], _chunk_size(traffic)
    t = traffic["table"]
    if out is None:
        out = torch.empty((len(indices), t["regions"], t["dim"]), dtype=table_dtype(traffic),
                          device=device)
    indices = np.asarray(indices)
    which = indices // chunk
    contiguous = bool(np.all(np.diff(indices) == 1))
    for c in np.unique(which):
        start = int(c) * chunk
        rows = _chunk(seed, int(c), min(start + chunk, images) - start, traffic, device)
        at = np.nonzero(which == c)[0]
        if contiguous:
            out[at[0]:at[-1] + 1] = rows[indices[at[0]] - start:indices[at[-1]] - start + 1]
        else:
            out[torch.from_numpy(at).to(device)] = rows[torch.from_numpy(indices[at] - start)
                                                        .to(device)]
    return out
