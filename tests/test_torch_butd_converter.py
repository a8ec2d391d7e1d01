"""The port's BUTD TSV converter (vqa_tpu_torch.tools.convert_butd_tsv)
against the repo-root tools/convert_butd_tsv.py on a synthetic TSV built as
tests/test_butd_converter.py builds one: the same HDF5 datasets (features,
boxes, the noatt mean) and names files, and the port's FeatureStore reading
them back."""

import base64
import json

import numpy as np
import pytest
import torch

from vqa_tpu_torch.datasets.features import FeatureStore, feature_paths
from vqa_tpu_torch.tools.convert_butd_tsv import main as port_main

torch.set_num_threads(1)


def _write_tsv(path, rows):
    """tests/test_butd_converter.py's TSV writer (copied: the card's test
    run collects this file and has no JAX package dependencies)."""
    with open(path, "w") as f:
        for image_id, feats, boxes in rows:
            f.write("\t".join([str(image_id), "640", "480", str(feats.shape[0]),
                               base64.b64encode(boxes.tobytes()).decode(),
                               base64.b64encode(feats.tobytes()).decode()]) + "\n")


def _rows(seed, n, boxes=36, dim=64):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 600_000)), rng.standard_normal((boxes, dim)).astype(np.float32),
             rng.standard_normal((boxes, 4)).astype(np.float32)) for _ in range(n)]


def _h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k][:], f[k].chunks, f[k].maxshape) for k in f}


@pytest.mark.parametrize("argv", [
    ["--coco_split", "auto", "--boxes"],
    ["--coco_split", "val2014"],
    ["--coco_split", "train2014", "--arch", "butd10", "--boxes"],
])
def test_converter_equals_the_jax_tool(tmp_path, argv):
    from tools.convert_butd_tsv import main as jax_main

    shards = []
    for i, n in enumerate((3, 2)):  # two shards, comma-separated
        shards.append(str(tmp_path / f"shard{i}.tsv"))
        _write_tsv(shards[-1], _rows(i, n))
    tsv = ",".join(shards)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert port_main(["--tsv", tsv, "--dir_out", port_dir] + argv) == 0
    assert jax_main(["--tsv", tsv, "--dir_out", jax_dir] + argv) == 0
    arch = argv[argv.index("--arch") + 1] if "--arch" in argv else "bottomup36"
    for mode in ("att", "noatt"):
        (got_h5, got_names), (want_h5, want_names) = (feature_paths(d, arch, mode)
                                                      for d in (port_dir, jax_dir))
        got, want = _h5(got_h5), _h5(want_h5)
        assert sorted(got) == sorted(want) == (
            ["boxes", "features"] if mode == "att" and "--boxes" in argv else ["features"])
        for key in want:
            np.testing.assert_array_equal(got[key][0], want[key][0])
            assert got[key][1:] == want[key][1:]
        with open(got_names, "rb") as a, open(want_names, "rb") as b:
            assert a.read() == b.read()
    store = FeatureStore(port_dir, arch, "att")
    split = "train2014" if "auto" in argv or "train2014" in argv else "val2014"
    first = _rows(0, 3)[0]
    np.testing.assert_array_equal(
        store.get(store.index_of([f"COCO_{split}_{first[0]:012d}"]))[0], first[1])
    assert len(store) == 5 and store.feature_shape == (36, 64)


def test_converter_refuses_a_ragged_shard(tmp_path):
    """A row with another box count than the first raises, as in the JAX tool."""
    tsv = str(tmp_path / "ragged.tsv")
    _write_tsv(tsv, _rows(0, 1) + _rows(1, 1, boxes=10))
    with pytest.raises(ValueError, match="10 boxes != 36"):
        port_main(["--tsv", tsv, "--dir_out", str(tmp_path / "out")])


def test_converter_names_alias_one_row(tmp_path):
    """--coco_split auto names each row under train2014 and val2014."""
    tsv = str(tmp_path / "one.tsv")
    rows = _rows(2, 2)
    _write_tsv(tsv, rows)
    port_main(["--tsv", tsv, "--dir_out", str(tmp_path)])
    with open(feature_paths(str(tmp_path), "bottomup36", "noatt")[1]) as f:
        names = json.load(f)
    assert names == {f"COCO_{s}_{iid:012d}": i for i, (iid, _, _) in enumerate(rows)
                     for s in ("train2014", "val2014")}
    noatt = FeatureStore(str(tmp_path), "bottomup36", "noatt")
    np.testing.assert_allclose(noatt.as_array(), np.stack([r[1].mean(axis=0) for r in rows]),
                               rtol=1e-6)
