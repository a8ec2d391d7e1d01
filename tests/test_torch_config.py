"""The port's copy of the config system (vqa_tpu_torch/config.py) against
the original (vqa_tpu/config.py): every options/vqa2 YAML gives the same
typed Options tree and the same merged dict, with no overrides, with
"key.sub=value" overrides and with typed (key, value) tuples."""

import dataclasses
import glob
import os

import pytest

from vqa_tpu.config import load_options as jax_load_options
from vqa_tpu_torch.config import load_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "options", "vqa2", "*.yaml")))
OVERRIDES = {
    "none": [],
    "strings": ["vqa.nans=20", "vqa.pad=left", "model.seq2vec.hidden_size=32",
                "engine.dtype=bfloat16", "optim.lr=0.5"],
    "tuples": [("optim.lr", 1e-05), ("vqa.maxlength", 14), "coco.dir=/data/coco"],
}


def test_every_vqa2_config_is_covered():
    assert len(YAMLS) == 8


@pytest.mark.parametrize("overrides", list(OVERRIDES.values()), ids=list(OVERRIDES))
@pytest.mark.parametrize("path", YAMLS, ids=[os.path.basename(p) for p in YAMLS])
def test_load_options_matches_the_original(path, overrides):
    got, want = load_options(path, overrides), jax_load_options(path, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.raw == want.raw
