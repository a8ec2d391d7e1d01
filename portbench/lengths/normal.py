"""Question lengths as a normal, rounded and clipped: ``{"kind": "normal",
"mean", "sd", "min", "max"}`` (the arithmetic of ``bench.py``'s
``_synthetic_eval_arrays``, copied)."""

import numpy as np


def draw(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.clip(np.round(rng.normal(spec["mean"], spec["sd"], n)),
                   spec["min"], spec["max"]).astype(np.int32)
