"""The port's data parallelism across processes (vqa_tpu_torch.parallel, the
train step's grad reduction, the row-sharded table) on the CPU, over gloo.

The ranks are real processes (a script per rank, joined through a
``file://`` store under the test's tmp_path, each with its own timeout); the
test process holds what they write against:
  1. the JAX package's ``make_train_step`` on an 8-device mesh (the tiny
     MLBAtt of tests/test_multidevice_training.py, dropout off, sgd): losses
     within 1e-5 relative, parameters within rtol 2e-4, atol 1e-5, the JAX
     package's own bound for its 8-device run against one device;
  2. the port's own step in one process, with adam and the global-norm clip:
     the same bounds, the glimpse bias (its grad is 0 but for rounding,
     which adam scales up to +-lr a step) within lr x steps on both sides;
  3. the replicated table: 11 images over 2 ranks (so the last rank holds a
     pad row), the float32 table and the int8 pair, rows bit-exact (-0.0
     features included) and the eval step's pred and correct1 equal;
and ``flagship.dryrun_multigpu`` runs over 2 and 4 ranks.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.config import ModelOptions
from vqa_tpu.config import OptimOptions as JaxOptimOptions
from vqa_tpu.engine.optim import criterion_factory, factory as jax_optim_factory
from vqa_tpu.engine.steps import create_state, make_train_step as jax_make_train_step
from vqa_tpu.importers import flatten_tree
from vqa_tpu.models import factory as jax_factory
from vqa_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh, replicated
from vqa_tpu_torch import flagship, parallel
from vqa_tpu_torch.config import OptimOptions
from vqa_tpu_torch.engine import optim, steps
from vqa_tpu_torch.models.factory import factory as port_factory
from vqa_tpu_torch.ops.gather import gather_rows
from vqa_tpu_torch.parallel.mesh import Mesh, ShardedTable, shard_rows
from vqa_tpu_torch.weights import export_params, load_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, R, DV, T, VOCAB, NANS = 16, 5, 16, 6, 31, 11
K_STEPS = 4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)
RANK_TIMEOUT = 120
# the tiny MLBAtt of tests/test_multidevice_training.py, its dropout off
# (the two packages' dropout streams differ)
MODEL = ModelOptions(
    arch="MLBAtt",
    seq2vec={"arch": "lstm", "emb_size": 8, "hidden_size": 16},
    attention={"nb_glimpses": 2, "dim_h": 16, "dropout_v": 0.0, "dropout_q": 0.0,
               "dropout_mm": 0.0},
    fusion={"arch": "mlb", "dim_h": 16, "dropout_v": 0.0, "dropout_q": 0.0},
    classif={"dropout": 0.0},
)
CANCELLING = "glimpse_logits/bias"

RANK_SCRIPT = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from vqa_tpu_torch import parallel
from vqa_tpu_torch.config import OptimOptions
from vqa_tpu_torch.engine import optim, steps
from vqa_tpu_torch.models.factory import factory
from vqa_tpu_torch.ops.gather import gather_rows, gather_rows_dequant
from vqa_tpu_torch.parallel.mesh import local_rows, shard_feature_table
from vqa_tpu_torch.weights import export_params, load_params

mode, rank, world, store, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
with open(f"{work}/spec.json") as f:
    spec = json.load(f)
with np.load(f"{work}/spec.npz") as npz:
    arrays = {k: npz[k] for k in npz.files}
parallel.initialize(store, world, rank, device="cpu")
mesh = parallel.make_mesh()
lo, hi = local_rows(spec["batch"], mesh)
out = {"place": np.asarray([parallel.process_index(), parallel.process_count(),
                            parallel.is_primary()])}


def model(train):
    m = factory(spec["model"], spec["num_words"], spec["num_answers"], dim_v=spec["dim_v"],
                train=train)
    load_params(m, {k[6:]: v for k, v in arrays.items() if k.startswith("param:")})
    return m


def local(prefix, keys):
    return {k: torch.from_numpy(arrays[prefix + k][lo:hi]) for k in keys}


if mode == "train":
    state = steps.create_state(model(True), optim.factory(OptimOptions(**spec["optim"]), 1))
    step = steps.make_train_step(optim.criterion_factory(), seed=0, mesh=mesh)
    metrics = []
    for k in range(spec["steps"]):
        state, m = step(state, local(f"batch{k}:", ("visual", "question", "length", "answer")))
        metrics.append([float(m[key]) for key in ("loss", "acc1", "acc5", "gnorm")])
    out["metrics"] = np.asarray(metrics)
    out.update({f"param:{k}": v for k, v in export_params(state.model).items()})
elif mode == "sharded":
    eval_step, net = steps.make_eval_step(), model(False)
    batch = local("", ("question", "length", "answer"))
    batch["image_index"] = arrays["image_index"][lo:hi]
    table = torch.from_numpy(arrays["table"])
    pair = (torch.from_numpy(arrays["values"]), torch.from_numpy(arrays["scales"]))
    for name, full in (("float32", table), ("int8", pair)):
        sharded = shard_feature_table(full, mesh)
        out[f"{name}:shard_rows"] = np.asarray(
            (sharded.local[0] if name == "int8" else sharded.local).shape[0])
        out[f"{name}:got"] = sharded.gather(batch["image_index"]).numpy()
        out[f"{name}:want"] = (gather_rows_dequant(*pair, batch["image_index"]) if name == "int8"
                               else gather_rows(table, batch["image_index"])).numpy()
        for label, features in (("rep", full), ("shd", sharded)):
            res = eval_step(net, batch, features)
            out[f"{name}:{label}_pred"] = res["pred"].numpy()
            out[f"{name}:{label}_correct1"] = res["correct1"].numpy()
parallel.shutdown()
np.savez(f"{work}/rank{rank}.npz", **out)
'''


def _ranks(work, mode, spec, arrays, world=2):
    """Run ``world`` rank processes in ``mode``; returns each rank's npz
    as a dict."""
    with open(work / "spec.json", "w") as f:
        json.dump(spec, f)
    np.savez(work / "spec.npz", **arrays)
    script = work / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), mode, str(r), str(world),
                               f"file://{work}/store", str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with np.load(work / f"rank{r}.npz") as npz:
            results.append({k: npz[k] for k in npz.files if k != "place"})
            assert npz["place"].tolist() == [r, world, r == 0]
    return results


def _setup():
    """The tiny MLBAtt's flax params and K_STEPS batches, as
    tests/test_multidevice_training.py::_setup draws them."""
    model = jax_factory(MODEL, VOCAB, NANS)
    rng = np.random.default_rng(3)
    batches = [{
        "visual": rng.standard_normal((B, R, DV)).astype(np.float32),
        "question": rng.integers(1, VOCAB, (B, T)).astype(np.int32),
        "length": np.full((B,), T, np.int32),
        "answer": rng.integers(0, NANS, (B,)).astype(np.int32),
    } for _ in range(K_STEPS)]
    params = model.init(jax.random.key(0), jnp.asarray(batches[0]["visual"]),
                        jnp.asarray(batches[0]["question"]),
                        jnp.asarray(batches[0]["length"]))["params"]
    return model, params, batches


def _spec(knobs):
    return {"model": dataclasses.asdict(MODEL), "num_words": VOCAB, "num_answers": NANS,
            "dim_v": DV, "batch": B, "steps": K_STEPS, "optim": knobs}


def _arrays(params, batches):
    arrays = {f"param:{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    for k, batch in enumerate(batches):
        arrays.update({f"batch{k}:{key}": v for key, v in batch.items()})
    return arrays


def _assert_ranks_agree(ranks):
    """Every rank holds the global batch's metrics and the same parameters."""
    for other in ranks[1:]:
        assert set(other) == set(ranks[0])
        for key, value in ranks[0].items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_dp_step_matches_the_jax_8_device_step(tmp_path):
    """Two port ranks, 8 rows each, 4 sgd steps (lr 0.1, momentum 0) against
    the JAX package's make_train_step over an 8-device mesh at batch 16,
    from the same weights."""
    model, params, batches = _setup()
    knobs = dict(lr=0.1, optimizer="sgd", momentum=0.0)
    ranks = _ranks(tmp_path, "train", _spec(knobs), _arrays(params, batches))
    _assert_ranks_agree(ranks)

    mesh = jax_make_mesh(jax.devices()[:8])
    state = jax.device_put(create_state(model, params, jax_optim_factory(JaxOptimOptions(**knobs),
                                                                         1)),
                           replicated(mesh))
    step = jax_make_train_step(criterion_factory(), donate=False)
    losses = []
    for batch in batches:
        state, metrics = step(state, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                                    batch_sharding(mesh)), jax.random.key(7))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(ranks[0]["metrics"][:, 0], losses, rtol=LOSS_RTOL)
    want = flatten_tree(jax.device_get(state.params))
    got = {k[6:]: v for k, v in ranks[0].items() if k.startswith("param:")}
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], np.asarray(value), **PARAM_TOL, err_msg=key)


def test_dp_step_matches_one_process_with_adam_and_the_clip(tmp_path):
    """Two ranks against the port's step in one process at the whole batch,
    adam (lr 1e-3) after the global-norm clip (0.05, below every step's
    norm, so it clips): each step's loss, acc1, acc5 and gnorm (the norm of
    the reduced grads) and the final parameters."""
    _, params, batches = _setup()
    knobs = dict(lr=1e-3, optimizer="adam", grad_clip=0.05)
    ranks = _ranks(tmp_path, "train", _spec(knobs), _arrays(params, batches))
    _assert_ranks_agree(ranks)

    net = port_factory(dataclasses.asdict(MODEL), VOCAB, NANS, dim_v=DV, train=True)
    start = flatten_tree(params)
    load_params(net, start)
    state = steps.create_state(net, optim.factory(OptimOptions(**knobs), 1))
    step = steps.make_train_step(optim.criterion_factory(), seed=0)
    want = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        want.append([float(m[key]) for key in ("loss", "acc1", "acc5", "gnorm")])
    want = np.asarray(want)
    got = ranks[0]["metrics"]
    assert (want[:, 3] > knobs["grad_clip"]).all()  # the clip acted on every step
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[:, 1:3], want[:, 1:3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=LOSS_RTOL)
    single = export_params(net)
    for key, value in single.items():
        dp = ranks[0][f"param:{key}"]
        if key.endswith(CANCELLING):
            for moved in (dp, value):
                assert np.abs(moved - np.asarray(start[key])).max() <= \
                    knobs["lr"] * K_STEPS * 1.001, key
            continue
        np.testing.assert_allclose(dp, value, **PARAM_TOL, err_msg=key)


def test_sharded_table_matches_the_replicated_one(tmp_path):
    """11 images over 2 ranks (6 rows each, the second's last a pad row,
    then the sink row): each rank's gathered rows bit-equal to the
    replicated table's, -0.0 features kept, and its eval step's pred and
    correct1 equal, for the float32 table and the int8 pair."""
    from vqa_tpu_torch.engine.steps import quantize_features

    _, params, batches = _setup()
    rng = np.random.default_rng(5)
    n_images = 11
    table = rng.standard_normal((n_images, R, DV)).astype(np.float32)
    table[::2, 0, :3] = -0.0  # the sink's -0.0 must keep these bit for bit
    values, scales = quantize_features(table)
    idx = rng.integers(0, n_images, B).astype(np.int32)
    idx[:4] = [0, 5, 6, 10]  # each rank's first and last real row
    arrays = {f"param:{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    arrays.update(table=table, values=values, scales=scales, image_index=idx,
                  question=batches[0]["question"], length=batches[0]["length"],
                  answer=batches[0]["answer"])
    ranks = _ranks(tmp_path, "sharded", _spec({}), arrays)
    for rank, out in enumerate(ranks):
        for name in ("float32", "int8"):
            assert int(out[f"{name}:shard_rows"]) == 7  # ceil(11 / 2) + the sink
            got, want = out[f"{name}:got"], out[f"{name}:want"]
            assert got.shape == want.shape == (B // 2, R, DV)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"rank {rank} {name}")
            np.testing.assert_array_equal(out[f"{name}:shd_pred"], out[f"{name}:rep_pred"])
            assert int(out[f"{name}:shd_correct1"]) == int(out[f"{name}:rep_correct1"])
    assert np.signbit(ranks[0]["float32:got"][0, 0, :3]).all()  # row 0's -0.0 kept


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multigpu_on_the_host(n, capsys):
    """flagship.dryrun_multigpu over n gloo ranks on the host, on its default
    mesh (2 ranks: 2x1; 4 ranks: 2x2, as __graft_entry__.dryrun_multichip
    lays out an even world of at least 4): the ranks agree on the global
    losses, which fall over 5 steps on a fixed batch, then one sharded eval
    step."""
    record = flagship.dryrun_multigpu(n, platform="cpu", timeout=RANK_TIMEOUT)
    mp = 2 if n == 4 else 1
    assert record["mesh"] == {"data": n // mp, "model": mp, "data_index": 0, "model_index": 0,
                              "backend": "gloo"}
    assert record["steps"] == 5 and record["losses"][-1] < record["losses"][0]
    assert f"dryrun_multigpu({n}, tp={mp}): ok" in capsys.readouterr().out


def test_one_process_mesh_and_shard():
    """Without a process group the mesh is one rank and the "shard" is the
    whole table and its sink; the sharded gather is then the plain one."""
    mesh = parallel.make_mesh()
    assert mesh == Mesh() and not mesh.distributed
    assert (parallel.process_index(), parallel.process_count(), parallel.is_primary()) == \
        (0, 1, True)
    parallel.barrier()  # a no-op without a group
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32))
    shard = shard_rows(table, mesh)
    assert shard.shape == (6, 3) and torch.equal(shard[:5], table)
    assert torch.signbit(shard[5]).all() and not shard[5].any()
    idx = np.array([4, 0, 2, 2], np.int32)
    got = ShardedTable(shard, 5, mesh).gather(idx)
    assert torch.equal(got, gather_rows(table, idx))
    with pytest.raises(IndexError, match=r"\[0, 5\)"):
        ShardedTable(shard, 5, mesh).gather(np.array([5]))


def test_mesh_refuses_tensor_parallelism_and_odd_batches():
    """A world that model_parallel does not divide (one process here), as
    the JAX make_mesh refuses it; a batch the data axis does not divide."""
    with pytest.raises(ValueError, match="1 process\\(es\\) not divisible by model_parallel=2"):
        parallel.make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="divisible by data-parallel size 3"):
        parallel.check_batch_divisible(16, Mesh(data=3))


def test_initialize_refuses_nccl_on_the_host():
    with pytest.raises(RuntimeError, match="NCCL moves card tensors only"):
        parallel.initialize("localhost:1", 1, 0, backend="nccl", device="cpu")
