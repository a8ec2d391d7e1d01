"""Region/grid feature store, a copy of ``vqa_tpu/datasets/features.py`` (the
port imports nothing of the JAX package). ``h5py`` is imported when a table
is written or opened, not when the module is imported, so the port loads on a
machine without it; there, ``FeatureStore.in_memory`` builds the store from
an array.

Precomputed image features (bottom-up 36x2048 regions, or pooled 2048-d
vectors for noatt mode) live in HDF5 next to a name->index table:

  <coco_dir>/extract/<arch>_<mode>.h5      dataset 'features'
  <coco_dir>/extract/<arch>_<mode>_names.json

The store can preload the full table into host RAM, so a batch's gather is a
single numpy fancy-index.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np


def feature_paths(coco_dir: str, arch: str, mode: str) -> tuple:
    base = os.path.join(coco_dir, "extract", f"{arch}_{mode}")
    return base + ".h5", base + "_names.json"


def write_features(
    coco_dir: str,
    arch: str,
    mode: str,
    names: Sequence[str],
    features: np.ndarray,
) -> str:
    """Write a feature table (as the fixture generator and extract.py do)."""
    import h5py

    h5_path, names_path = feature_paths(coco_dir, arch, mode)
    os.makedirs(os.path.dirname(h5_path), exist_ok=True)
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("features", data=features, chunks=True)
    with open(names_path, "w") as f:
        json.dump(list(names), f)
    return h5_path


class FeatureStore:
    """Name-indexed random access over the feature table.

    cache='ram'  — load everything into host memory once (default; fast path)
    cache='h5'   — leave data in the file, read per batch (low-memory path)
    """

    def __init__(self, coco_dir: str, arch: str, mode: str, cache: str = "ram"):
        import h5py

        self.h5_path, names_path = feature_paths(coco_dir, arch, mode)
        if not os.path.exists(self.h5_path):
            raise FileNotFoundError(
                f"feature table {self.h5_path} not found; run extract.py or the "
                "fixture generator (python -m vqa_tpu.datasets.fixtures)"
            )
        with open(names_path) as f:
            names = json.load(f)
        # list: row i is named names[i]; dict: explicit name -> row index
        # (lets several names alias one feature row, e.g. the published
        # bottom-up trainval shard where train2014/val2014 share ids)
        self._name_to_index: Dict[str, int] = (
            names if isinstance(names, dict) else {n: i for i, n in enumerate(names)}
        )
        self._cache_mode = cache
        self._file = None
        self._ram = None
        if cache == "ram":
            with h5py.File(self.h5_path, "r") as f:
                self._ram = f["features"][:]
            self.shape = self._ram.shape
            self.dtype = self._ram.dtype
        else:
            self._file = h5py.File(self.h5_path, "r")
            self.shape = self._file["features"].shape
            self.dtype = self._file["features"].dtype

    @classmethod
    def in_memory(cls, names: Sequence[str], features: np.ndarray) -> "FeatureStore":
        """A store over ``features`` already in host memory, row i named
        ``names[i]``: the cache='ram' store without its HDF5 file, for a
        machine without h5py."""
        if len(names) != features.shape[0]:
            raise ValueError(f"{len(names)} names for {features.shape[0]} feature rows")
        store = cls.__new__(cls)
        store.h5_path = "<in memory>"
        store._name_to_index = {n: i for i, n in enumerate(names)}
        store._cache_mode, store._file, store._ram = "ram", None, features
        store.shape, store.dtype = features.shape, features.dtype
        return store

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def feature_shape(self) -> tuple:
        return tuple(self.shape[1:])

    @property
    def names(self) -> list:
        """Image names ordered by row index (aliases keep the first name)."""
        out: Dict[int, str] = {}
        for name, idx in self._name_to_index.items():
            out.setdefault(idx, name)
        return [out[i] for i in sorted(out)]

    def index_of(self, names: Sequence[str]) -> np.ndarray:
        try:
            return np.asarray([self._name_to_index[n] for n in names], dtype=np.int32)
        except KeyError as e:
            raise KeyError(f"image {e.args[0]!r} missing from {self.h5_path}") from None

    def get(self, indices: np.ndarray) -> np.ndarray:
        if self._ram is not None:
            return self._ram[indices]
        # h5py fancy selection needs sorted UNIQUE indices (batches repeat an
        # image whenever two questions share it): read unique, then expand
        unique, inverse = np.unique(indices, return_inverse=True)
        data = self._file["features"][unique.tolist()]
        return data[inverse]

    def as_array(self) -> np.ndarray:
        """Full table (preloads if in h5 mode)."""
        if self._ram is None:
            self._ram = self._file["features"][:]
        return self._ram

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
