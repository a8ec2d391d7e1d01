"""Convert published bottom-up-attention TSV shards to the feature store's
layout, the port of the repo-root ``tools/convert_butd_tsv.py``: the same
fields, HDF5 datasets and names file, written with the port's
``feature_paths`` and ``image_name``. A host tool: it needs h5py (imported
when it runs), which the card's machine does not have.

The public TSV format (Anderson et al. release) has one row per image:
  image_id \\t image_w \\t image_h \\t num_boxes \\t boxes(b64) \\t features(b64)
with features base64-encoded float32 [num_boxes, 2048] and boxes
[num_boxes, 4]. Boxes are kept in a parallel dataset (``--boxes``) so
attention visualizations can draw them.

  python -m vqa_tpu_torch.tools.convert_butd_tsv --tsv trainval_36.tsv[,more.tsv] \\
      --dir_out data/coco --coco_split auto [--boxes]

writes ``<dir_out>/extract/<arch>_att.h5`` (``features`` [N, 36, 2048],
and ``boxes`` [N, 36, 4]), ``<arch>_noatt.h5`` (the mean over the boxes,
[N, 2048]) and a names json each: ``--coco_split auto`` names every row
under both train2014 and val2014 (the trainval shard), else under the
split given.
"""

from __future__ import annotations

import argparse
import base64
import csv
import json
import os
import sys

import numpy as np

from vqa_tpu_torch.datasets.features import feature_paths
from vqa_tpu_torch.datasets.interim import image_name

FIELDS = ["image_id", "image_w", "image_h", "num_boxes", "boxes", "features"]


def iter_rows(paths):
    """(image_id, features [n, dim], boxes [n, 4]) of each row of each shard."""
    csv.field_size_limit(sys.maxsize)
    for path in paths:
        with open(path) as f:
            for row in csv.DictReader(f, delimiter="\t", fieldnames=FIELDS):
                n = int(row["num_boxes"])
                feats = np.frombuffer(base64.b64decode(row["features"]),
                                      dtype=np.float32).reshape(n, -1)
                boxes = np.frombuffer(base64.b64decode(row["boxes"]),
                                      dtype=np.float32).reshape(n, 4)
                yield int(row["image_id"]), feats, boxes


def _append(ds, n_rows: int, row: np.ndarray) -> None:
    ds.resize(n_rows + 1, axis=0)
    ds[n_rows] = row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tsv", required=True, help="comma-separated tsv shard paths")
    p.add_argument("--dir_out", required=True, help="coco dir (writes extract/)")
    p.add_argument("--arch", default="bottomup36")
    p.add_argument("--coco_split", default="auto",
                   help="train2014|val2014|test2015, or 'auto' to alias both trainval names")
    p.add_argument("--boxes", action="store_true", help="also store region boxes")
    args = p.parse_args(argv)

    import h5py

    h5_path, names_path = feature_paths(args.dir_out, args.arch, "att")
    h5_noatt, names_noatt = feature_paths(args.dir_out, args.arch, "noatt")
    os.makedirs(os.path.dirname(h5_path), exist_ok=True)
    splits = ("train2014", "val2014") if args.coco_split == "auto" else (args.coco_split,)

    # streamed (the published trainval shard is ~35 GB, never held in RAM);
    # 'auto' names one stored row under both coco splits through the
    # dict-format names map (FeatureStore takes name -> index dicts)
    name_to_index = {}
    n_rows = 0
    with h5py.File(h5_path, "w") as f_att, h5py.File(h5_noatt, "w") as f_noatt:
        d_att = d_boxes = d_noatt = None
        for image_id, feats, boxes in iter_rows(args.tsv.split(",")):
            if d_att is None:
                n, dim = feats.shape
                d_att = f_att.create_dataset("features", shape=(0, n, dim),
                                             maxshape=(None, n, dim), dtype=np.float32,
                                             chunks=(64, n, dim))
                d_noatt = f_noatt.create_dataset("features", shape=(0, dim),
                                                 maxshape=(None, dim), dtype=np.float32,
                                                 chunks=(256, dim))
                if args.boxes:
                    d_boxes = f_att.create_dataset("boxes", shape=(0, n, 4),
                                                   maxshape=(None, n, 4), dtype=np.float32,
                                                   chunks=(256, n, 4))
            if feats.shape[0] != d_att.shape[1]:
                raise ValueError(
                    f"image {image_id}: {feats.shape[0]} boxes != {d_att.shape[1]} "
                    "(adaptive-box tsv needs the fixed-36 release or padding)")
            _append(d_att, n_rows, feats)
            _append(d_noatt, n_rows, feats.mean(axis=0))
            if args.boxes:
                _append(d_boxes, n_rows, boxes)
            for split in splits:
                name_to_index[image_name(split, image_id)] = n_rows
            n_rows += 1
            if n_rows % 1000 == 0:
                print(f"\rconverted {n_rows} images", end="", flush=True)
    print()

    for path in (names_path, names_noatt):
        with open(path, "w") as f:
            json.dump(name_to_index, f)
    print(f"wrote {h5_path} ({n_rows} rows) + noatt companion")
    return 0


if __name__ == "__main__":
    sys.exit(main())
