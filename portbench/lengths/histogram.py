"""Question lengths drawn from a histogram: ``{"kind": "histogram",
"lengths": [words, ...], "weights": [share, ...]}``, the weights in any
unit (a count or a percentage of questions at each length)."""

import numpy as np


def draw(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    weights = np.asarray(spec["weights"], np.float64)
    return rng.choice(np.asarray(spec["lengths"], np.int32), n, p=weights / weights.sum())
