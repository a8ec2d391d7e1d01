"""The models' parameters, by name and shape, and their values from a seed.

Names are the '/'-separated paths of the published layer layout (Dense
``kernel [in, out]`` and ``bias``; MUTAN's core ``w_core_q [dq, R*M]``;
the rest in each encoder's and architecture's file). The values are drawn
on ``device`` in ONE call of ``torch.randn`` from a generator seeded by
(seed, "weights"): embeddings
N(0, 1), matrices N(0, 1/fan_in) with fan_in their first axis, vectors
N(0, 0.01). The same seed and device give the same values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...]]]

# tags that keep the streams drawn from one run seed apart
WEIGHTS, TABLE, DATA, SAMPLE = 1, 2, 3, 4


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of a run, from the run's ``seed`` (any
    non-negative whole number) and ``tags``."""
    words = np.random.SeedSequence([int(seed), *tags]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2 ** 63 - 1)


def dense(name: str, d_in: int, d_out: int) -> Spec:
    return [(f"{name}/kernel", (d_in, d_out)), (f"{name}/bias", (d_out,))]


def mutan(name: str, dim_q: int, dim_v: int, fus: dict) -> Spec:
    rm = fus["R"] * fus["dim_mm"]
    return (dense(f"{name}/q_proj", dim_q, fus["dim_hq"])
            + dense(f"{name}/v_proj", dim_v, fus["dim_hv"])
            + [(f"{name}/w_core_q", (fus["dim_hq"], rm)), (f"{name}/w_core_v", (fus["dim_hv"], rm)),
               (f"{name}/b_core_q", (rm,)), (f"{name}/b_core_v", (rm,))])


def param_spec(cfg: dict, dim_v: int) -> Spec:
    """Every parameter of ``cfg``'s model over ``dim_v``-wide region
    features, by name and shape: the encoder's file's, then the
    architecture's file's (``models.encoder``, ``models.arch``)."""
    from portbench.reference import models

    enc = models.encoder(cfg)
    return enc.params(cfg) + models.arch(cfg).params(cfg, enc.width(cfg), dim_v)


def make_params(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 values of every parameter of ``spec`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS))
    total = sum(math.prod(shape) for _, shape in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, start = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        if name.endswith("embedding"):
            scale = 1.0
        elif len(shape) >= 2:
            scale = shape[0] ** -0.5
        else:
            scale = 0.1
        out[name] = flat[start:start + n].view(shape) * scale
        start += n
    return out
