"""Region/grid feature table, the read side of ``vqa_tpu/datasets/features.py``
(feature_paths, FeatureStore with cache='ram'), copied so that the port
imports nothing of the JAX package. ``h5py`` is imported when a table is
opened, not when the module is imported.

  <coco_dir>/extract/<arch>_<mode>.h5      dataset 'features'
  <coco_dir>/extract/<arch>_<mode>_names.json
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def feature_paths(coco_dir: str, arch: str, mode: str) -> tuple:
    base = os.path.join(coco_dir, "extract", f"{arch}_{mode}")
    return base + ".h5", base + "_names.json"


class FeatureTable:
    """The whole table read into host memory, and its name -> row map (a
    names list gives row i to names[i]; a dict may alias several names to
    one row)."""

    def __init__(self, coco_dir: str, arch: str, mode: str):
        import h5py

        self.h5_path, names_path = feature_paths(coco_dir, arch, mode)
        if not os.path.exists(self.h5_path):
            raise FileNotFoundError(
                f"feature table {self.h5_path} not found; run extract.py or the "
                "fixture generator (python -m vqa_tpu.datasets.fixtures)"
            )
        with open(names_path) as f:
            names = json.load(f)
        self.image_rows: Dict[str, int] = (
            names if isinstance(names, dict) else {n: i for i, n in enumerate(names)}
        )
        with h5py.File(self.h5_path, "r") as f:
            self.array: np.ndarray = f["features"][:]

    @property
    def feature_shape(self) -> tuple:
        return tuple(self.array.shape[1:])
