"""Question lengths uniform over the whole words ``min`` to ``max``, both
included: ``{"kind": "uniform", "min", "max"}``."""

import numpy as np


def draw(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(spec["min"], spec["max"] + 1, n).astype(np.int32)
