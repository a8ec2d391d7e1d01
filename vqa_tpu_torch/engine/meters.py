"""Host-side metric meters, a copy of ``vqa_tpu/engine/meters.py`` (the port
imports nothing of the JAX package)."""

from __future__ import annotations

import time
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MeterBank:
    """Named AverageMeters + wall-clock timers for a split's epoch."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}
        self._t0 = time.perf_counter()

    def update(self, values: Dict[str, float], n: int = 1):
        for key, val in values.items():
            self.meters.setdefault(key, AverageMeter()).update(float(val), n)

    def averages(self) -> Dict[str, float]:
        out = {k: m.avg for k, m in self.meters.items()}
        out["epoch_time"] = time.perf_counter() - self._t0
        return out

    def __getitem__(self, key: str) -> AverageMeter:
        return self.meters[key]

    def __contains__(self, key: str) -> bool:
        return key in self.meters
