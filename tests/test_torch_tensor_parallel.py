"""The port's tensor parallelism (vqa_tpu_torch.parallel.partition, the 2-D
mesh) on the CPU, over gloo.

The ranks are real processes (a script per rank, joined through a
``file://`` store under the test's tmp_path, each with its own timeout); the
test process holds what they write against:
  1. the leaf rule's picks: ``vqa_tpu.parallel.partition.tp_shardings``'s,
     key for key (tests/test_tensor_parallel.py's model at min_size 64, and
     options/vqa2/mutan_att.yaml's tree at full width at the default);
  2. the JAX package's ``make_train_step`` on its 8-device 4x2 and 2x4
     meshes (``shard_state_tp``, min_size 64), sgd, dropout off: losses
     within 1e-5 relative, parameters within rtol 2e-4, atol 1e-5 (the JAX
     package's own bounds), for the port's 2x2 and 1x4 worlds; with
     ``grad_accum=2`` as tests/test_grad_accum.py composes it with TP;
  3. the port's own step in one process, with adam and a global-norm clip
     that binds (the norm must be the whole grads'), and with dropout on
     over a 1x2 world (the ranks of a row draw the same masks): bit-equal;
  4. checkpoints: DP -> save -> TP, TP -> save -> one process, against the
     uninterrupted run;
  5. the feature table row-sharded over the whole world, bit-equal to the
     replicated gather;
and ``flagship.dryrun_multigpu`` runs a 2x2 mesh.
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
from vqa_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh
from vqa_tpu.parallel.partition import tp_shardings as jax_tp_shardings
from vqa_tpu.parallel import shard_state_tp as jax_shard_state_tp
from vqa_tpu_torch import flagship
from vqa_tpu_torch.config import OptimOptions
from vqa_tpu_torch.engine import optim, steps
from vqa_tpu_torch.engine.checkpoint import CheckpointManager
from vqa_tpu_torch.models.factory import factory as port_factory
from vqa_tpu_torch.parallel import Mesh, shard_state_tp, tp_shardings
from vqa_tpu_torch.parallel.partition import leaf_dim, state_layout
from vqa_tpu_torch.weights import export_params, load_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, R, DV, T, VOCAB, NANS = 16, 5, 16, 6, 31, 11
K_STEPS = 4
MIN_SIZE = 64  # the JAX tests' threshold at these widths
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)
RANK_TIMEOUT = 180
# tests/test_multidevice_training.py's tiny MLBAtt; its dropout off where a
# run is held against JAX (the two packages' dropout streams differ)
_DIMS = dict(seq2vec={"arch": "lstm", "emb_size": 8, "hidden_size": 16},
             attention={"nb_glimpses": 2, "dim_h": 16}, fusion={"arch": "mlb", "dim_h": 16})
DROPOUT = ModelOptions(arch="MLBAtt", **_DIMS)
MODEL = ModelOptions(
    arch="MLBAtt",
    seq2vec=_DIMS["seq2vec"],
    attention={**_DIMS["attention"], "dropout_v": 0.0, "dropout_q": 0.0, "dropout_mm": 0.0},
    fusion={**_DIMS["fusion"], "dropout_v": 0.0, "dropout_q": 0.0},
    classif={"dropout": 0.0},
)
CANCELLING = "glimpse_logits/bias"  # its grad is 0 but for rounding

RANK_SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from vqa_tpu_torch import parallel
from vqa_tpu_torch.config import OptimOptions
from vqa_tpu_torch.engine import optim, steps
from vqa_tpu_torch.engine.checkpoint import CheckpointManager
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
out = {}
# the data axis' reductions this rank runs (the train step's all_reduce)
reduces = []
_all_reduce_mean = parallel.Mesh.all_reduce_mean


def counted_all_reduce_mean(self, flat):
    reduces.append(flat.numel())
    return _all_reduce_mean(self, flat)


parallel.Mesh.all_reduce_mean = counted_all_reduce_mean


def model(train):
    m = factory(spec["model"], spec["num_words"], spec["num_answers"], dim_v=spec["dim_v"],
                train=train)
    load_params(m, {k[6:]: v for k, v in arrays.items() if k.startswith("param:")})
    return m


def local(mesh, prefix, keys):
    lo, hi = local_rows(spec["batch"], mesh)
    return {k: torch.from_numpy(arrays[prefix + k][lo:hi]) for k in keys}


def train(phase, mp):
    """Run one phase: a fresh state on the mesh of ``mp``, restored from a
    checkpoint where the phase names one, the phase's steps, then a save
    where it names one."""
    mesh = parallel.make_mesh(mp)
    state = steps.create_state(model(True), optim.factory(OptimOptions(**spec["optim"]), 1))
    state = parallel.shard_state_tp(state, mesh, min_size=spec["min_size"])
    if phase.get("restore"):
        CheckpointManager(phase["restore"]).restore(state, "latest")
    step = steps.make_train_step(optim.criterion_factory(), seed=0, mesh=mesh)
    metrics = []
    for k in phase["batches"]:
        state, m = step(state, local(mesh, f"batch{k}:", ("visual", "question", "length",
                                                           "answer")))
        metrics.append([float(m[key]) for key in ("loss", "acc1", "acc5", "gnorm")])
    if phase.get("save"):
        whole = parallel.gather_state(state)  # every rank of the row
        if mesh.rank == 0:
            CheckpointManager(phase["save"]).save(whole, 0, 0.5)
        parallel.barrier()
    return state, mesh, metrics


if mode == "train":
    metrics = []
    for phase in spec["phases"]:
        state, mesh, m = train(phase, phase["model_parallel"])
        metrics += m
    out["metrics"] = np.asarray(metrics)
    out["place"] = np.asarray([mesh.data, mesh.model, mesh.data_index, mesh.model_index,
                               mesh.rank])
    out.update({f"param:{k}": v for k, v in export_params(state.model).items()})
    keys = [n.replace(".", "/") for n, p in state.model.named_parameters() if p.requires_grad]
    out.update({f"state:{k}": np.asarray(np.shape(v)) for k, v in
                optim.state_arrays(state.opt_state, keys).items()})
    out["state_bytes"] = np.asarray(parallel.state_bytes(state.opt_state))
    out["reduces"] = np.asarray(len(reduces))
elif mode == "torn":
    # one update over a 1 x world row whose ranks hold different grads of
    # every replicated leaf (model index m adds m): the row must still agree
    mesh = parallel.make_mesh(world)
    state = steps.create_state(model(True), optim.factory(OptimOptions(**spec["optim"]), 1))
    state = parallel.shard_state_tp(state, mesh, min_size=spec["min_size"])
    keys = [n.replace(".", "/") for n, p in state.model.named_parameters() if p.requires_grad]
    draw = np.random.default_rng(0)
    grads = [torch.from_numpy(draw.standard_normal(tuple(p.shape)).astype(np.float32))
             for p in state.params]
    grads = [g if d is not None else g + mesh.model_index for g, d in zip(grads, state.layout.dims)]
    state.layout.apply(state, grads)
    out.update({f"grad:{k}": g.numpy() for k, g in zip(keys, grads)})
    out["replicated"] = np.asarray([k for k, d in zip(keys, state.layout.dims) if d is None])
    out.update({f"param:{k}": v for k, v in export_params(state.model).items()})
elif mode == "sharded":
    mesh = parallel.make_mesh(spec["model_parallel"])
    eval_step, net = steps.make_eval_step(), model(False)
    lo, hi = local_rows(spec["batch"], mesh)
    batch = local(mesh, "", ("question", "length", "answer"))
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


def _ranks(work, mode, spec, arrays, world):
    """Run ``world`` rank processes in ``mode``; returns each rank's npz
    as a dict."""
    work.mkdir(exist_ok=True)
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
            results.append({k: npz[k] for k in npz.files})
    return results


def _setup(model=MODEL, seed=3, batch=B, dv=DV, nans=NANS, steps_=K_STEPS):
    """A tiny model's flax params and its batches, drawn as
    tests/test_multidevice_training.py::_setup draws them."""
    jax_model = jax_factory(model, VOCAB, nans)
    rng = np.random.default_rng(seed)
    batches = [{
        "visual": rng.standard_normal((batch, R, dv)).astype(np.float32),
        "question": rng.integers(1, VOCAB, (batch, T)).astype(np.int32),
        "length": np.full((batch,), T, np.int32),
        "answer": rng.integers(0, nans, (batch,)).astype(np.int32),
    } for _ in range(steps_)]
    params = jax_model.init(jax.random.key(0), jnp.asarray(batches[0]["visual"]),
                            jnp.asarray(batches[0]["question"]),
                            jnp.asarray(batches[0]["length"]))["params"]
    return jax_model, params, batches


def _spec(knobs, phases, model=MODEL, batch=B, dv=DV, nans=NANS):
    return {"model": dataclasses.asdict(model), "num_words": VOCAB, "num_answers": nans,
            "dim_v": dv, "batch": batch, "optim": knobs, "min_size": MIN_SIZE,
            "phases": phases}


def _arrays(params, batches):
    arrays = {f"param:{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    for k, batch in enumerate(batches):
        arrays.update({f"batch{k}:{key}": v for key, v in batch.items()})
    return arrays


def _params(rank_out):
    return {k[6:]: v for k, v in rank_out.items() if k.startswith("param:")}


def _assert_ranks_agree(ranks):
    """Every rank holds the global batch's metrics and the same parameters,
    bit for bit (the gathered slices of a row are not torn)."""
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["metrics"], ranks[0]["metrics"])
        for key, value in _params(ranks[0]).items():
            np.testing.assert_array_equal(other[f"param:{key}"], value, err_msg=key)


def _one_process(params, batches, knobs, model=MODEL, nans=NANS, dv=DV):
    """The port's step in one process over the whole batches: (metrics,
    params, state)."""
    net = port_factory(dataclasses.asdict(model), VOCAB, nans, dim_v=dv, train=True)
    load_params(net, flatten_tree(params))
    state = steps.create_state(net, optim.factory(OptimOptions(**knobs), 1))
    step = steps.make_train_step(optim.criterion_factory(), seed=0)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append([float(m[key]) for key in ("loss", "acc1", "acc5", "gnorm")])
    return np.asarray(metrics), export_params(net), state


def _jax_run(model, params, batches, knobs, model_parallel):
    """The JAX package's step over its 8-device mesh ``8/mp x mp``, the state
    laid out by its ``shard_state_tp`` (min_size 64): (losses, params)."""
    mesh = jax_make_mesh(jax.devices()[:8], model_parallel=model_parallel)
    state = jax_shard_state_tp(
        create_state(model, params, jax_optim_factory(JaxOptimOptions(**knobs), 1)), mesh,
        min_size=MIN_SIZE)
    step = jax_make_train_step(criterion_factory(), donate=False)
    losses = []
    for batch in batches:
        state, metrics = step(state, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                                    batch_sharding(mesh)), jax.random.key(7))
        losses.append(float(metrics["loss"]))
    return losses, flatten_tree(jax.device_get(state.params))


def _jax_picks(shardings):
    """A JAX sharding tree's picks: the dimension named 'model', or None."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        spec = tuple(s.spec)
        out["/".join(k.key for k in path)] = spec.index("model") if "model" in spec else None
    return out


# -- 1. the leaf rule --------------------------------------------------------

@pytest.mark.parametrize("model_parallel", [2, 4])
def test_leaf_picks_match_jax_on_the_tiny_model(model_parallel):
    """tests/test_tensor_parallel.py's model at min_size 64: the picks equal
    the JAX picks key for key; the 31-row embedding stays replicated."""
    jax_model, params, _ = _setup(DROPOUT, seed=0, steps_=1)
    mesh = jax_make_mesh(jax.devices()[:8], model_parallel=model_parallel)
    want = _jax_picks(jax_tp_shardings(params, mesh, min_size=MIN_SIZE))
    net = port_factory(dataclasses.asdict(DROPOUT), VOCAB, NANS, dim_v=DV, train=True)
    got = tp_shardings({n.replace(".", "/"): p for n, p in net.named_parameters()},
                       Mesh(model=model_parallel), min_size=MIN_SIZE)
    assert got == want
    assert got["encoder/embed/embedding"] is None
    assert any(d is not None for d in got.values())


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_leaf_picks_match_jax_on_full_width_mutan_att(model_parallel):
    """options/vqa2/mutan_att.yaml's tree at full width (shapes only, on the
    meta device and through ``jax.eval_shape``), the default min_size: the
    picks equal the JAX picks; at 2 the rule shards 12 of 24 leaves
    (46,066,900 of 46,091,272 parameters), at 4 the 2550-wide MUTAN cores
    stay replicated (2550 is no multiple of 4)."""
    opts = flagship.model_options(name="mutan_att")
    jax_model = jax_factory(ModelOptions(**opts), flagship.NUM_WORDS, flagship.NUM_ANSWERS)
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.key(0), jnp.zeros((2, 36, 2048), jnp.float32),
                               jnp.ones((2, 7), jnp.int32))["params"])
    mesh = jax_make_mesh(jax.devices()[:8], model_parallel=model_parallel)
    want = _jax_picks(jax_tp_shardings(shapes, mesh))
    net = port_factory(opts, flagship.NUM_WORDS, flagship.NUM_ANSWERS, device="meta", train=True)
    leaves = {n.replace(".", "/"): tuple(p.shape) for n, p in net.named_parameters()}
    got = tp_shardings(leaves, Mesh(model=model_parallel))
    assert got == want
    sharded = [k for k, d in got.items() if d is not None]
    assert len(leaves) == 24
    cores = {"attention/fusion/w_core_q", "attention/fusion/w_core_v",
             "final_fusion/w_core_q", "final_fusion/w_core_v"}
    if model_parallel == 2:
        assert len(sharded) == 12
        assert sum(int(np.prod(leaves[k])) for k in sharded) == 46_066_900
        assert cores <= set(sharded)
    else:
        assert not cores & set(sharded) and all(leaves[k][1] == 2550 for k in cores)


def test_layout_slices_are_contiguous_blocks_in_model_order():
    """``Layout.local`` (a tensor) and ``Layout.view`` (a host array) cut the
    same block; the blocks of every model index, in order, are the leaf."""
    net = port_factory(dataclasses.asdict(MODEL), VOCAB, NANS, dim_v=DV, train=True)
    state = steps.create_state(net, optim.factory(OptimOptions(lr=0.1), 1))
    for mp in (2, 4):
        layouts = [state_layout(state, Mesh(model=mp, model_index=m), MIN_SIZE)
                   for m in range(mp)]
        assert {0, 1} <= {d for d in layouts[0].dims if d is not None}  # both dims picked
        for i, p in enumerate(state.params):
            dim = layouts[0].dims[i]
            whole = p.detach()
            blocks = [lay.local(i, whole) for lay in layouts]
            views = [lay.view(i, whole.numpy()) for lay in layouts]
            for block, view in zip(blocks, views):
                np.testing.assert_array_equal(block.numpy(), view)
            if dim is None:
                assert all(b is whole for b in blocks)
            else:
                assert blocks[0].shape[dim] * mp == whole.shape[dim]
                assert torch.equal(torch.cat(blocks, dim), whole)
    with pytest.raises(ValueError, match="laid out already"):
        shard_state_tp(shard_state_tp(state, Mesh(model=2)), Mesh(model=2))


# -- 2. the TP step against the JAX package's ----------------------------------

WORLDS = [(4, 2), (4, 4)]  # (processes, model_parallel): 2x2 and 1x4


@pytest.mark.parametrize("world,mp", WORLDS, ids=["2x2_vs_jax_4x2", "1x4_vs_jax_2x4"])
def test_tp_step_matches_the_jax_tp_step(tmp_path, world, mp):
    """4 sgd steps (lr 0.1, momentum 0: tests/test_tensor_parallel.py's) of
    the port's world against the JAX step on its 8-device mesh of the same
    model axis, at the same global batch of 16, from the same weights."""
    model, params, batches = _setup()
    knobs = dict(lr=0.1, optimizer="sgd", momentum=0.0)
    phases = [{"model_parallel": mp, "batches": list(range(K_STEPS))}]
    ranks = _ranks(tmp_path, "train", _spec(knobs, phases), _arrays(params, batches), world)
    _assert_ranks_agree(ranks)
    assert [tuple(r["place"][:2]) for r in ranks] == [(world // mp, mp)] * world

    losses, want = _jax_run(model, params, batches, knobs, mp)
    np.testing.assert_allclose(ranks[0]["metrics"][:, 0], losses, rtol=LOSS_RTOL)
    got = _params(ranks[0])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], np.asarray(value), **PARAM_TOL, err_msg=key)


@pytest.mark.parametrize("world,mp", WORLDS, ids=["2x2", "1x4"])
def test_tp_step_matches_one_process_with_adam_and_the_clip(tmp_path, world, mp):
    """Adam (lr 1e-3) after a global-norm clip of 0.05, below every step's
    norm, so it binds: the clip must see the whole grads' norm, not a rank's
    slices. Each step's loss, acc1, acc5 and gnorm and the final parameters
    against the port's one process (the glimpse bias, whose grad is 0 but
    for rounding, within lr x steps on both sides); each rank's adam moments
    of a sharded leaf hold 1/mp of it, by shape."""
    _, params, batches = _setup()
    knobs = dict(lr=1e-3, optimizer="adam", grad_clip=0.05)
    phases = [{"model_parallel": mp, "batches": list(range(K_STEPS))}]
    ranks = _ranks(tmp_path, "train", _spec(knobs, phases), _arrays(params, batches), world)
    _assert_ranks_agree(ranks)

    want, single, state = _one_process(params, batches, knobs)
    got = ranks[0]["metrics"]
    assert (want[:, 3] > knobs["grad_clip"]).all()  # the clip acted on every step
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[:, 1:3], want[:, 1:3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=LOSS_RTOL)
    start = flatten_tree(params)
    for key, value in single.items():
        tp = ranks[0][f"param:{key}"]
        if key.endswith(CANCELLING):
            for moved in (tp, value):
                assert np.abs(moved - np.asarray(start[key])).max() <= \
                    knobs["lr"] * K_STEPS * 1.001, key
            continue
        np.testing.assert_allclose(tp, value, **PARAM_TOL, err_msg=key)

    picks = tp_shardings(single, Mesh(model=mp), min_size=MIN_SIZE)
    assert any(d is not None for d in picks.values())
    whole_bytes = 0
    for key, dim in picks.items():
        whole = single[key].shape
        whole_bytes += 2 * single[key].nbytes
        for moment in ("mu", "nu"):
            for r in ranks:
                shape = tuple(r[f"state:1/{moment}/{key}"])
                assert shape == (whole if dim is None else tuple(
                    n // mp if d == dim else n for d, n in enumerate(whole))), (key, moment)
    assert all(int(r["state_bytes"]) < whole_bytes for r in ranks)


def test_grad_accum_composes_with_tp(tmp_path):
    """tests/test_grad_accum.py::test_grad_accum_composes_with_tp_sharding's
    setup (batch 8, 12-d regions, 7 answers; dropout off): sgd with
    ``grad_accum=2`` over one window as a 2x2 world against the JAX step
    on its 4x2 mesh; each rank's accumulator of a sharded leaf holds half of
    it, by shape, and the window moved the parameters."""
    model, params, batches = _setup(seed=0, batch=8, dv=12, nans=7, steps_=1)
    batches = batches * 2  # one window, the same batch twice, as the JAX test
    knobs = dict(lr=0.1, optimizer="sgd", momentum=0.0, grad_accum=2)
    phases = [{"model_parallel": 2, "batches": [0, 1]}]
    ranks = _ranks(tmp_path, "train", _spec(knobs, phases, batch=8, dv=12, nans=7),
                   _arrays(params, batches), 4)
    _assert_ranks_agree(ranks)
    losses, want = _jax_run(model, params, batches, knobs, 2)
    np.testing.assert_allclose(ranks[0]["metrics"][:, 0], losses, rtol=LOSS_RTOL)
    got = _params(ranks[0])
    start = flatten_tree(params)
    assert any(not np.allclose(got[k], np.asarray(start[k])) for k in got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], np.asarray(value), **PARAM_TOL, err_msg=key)
    picks = tp_shardings(got, Mesh(model=2), min_size=MIN_SIZE)
    for key, dim in picks.items():
        shape = tuple(ranks[1][f"state:grad_accum/{key}"])
        whole = got[key].shape
        assert shape == (whole if dim is None else tuple(
            n // 2 if d == dim else n for d, n in enumerate(whole))), key


# -- 3. a 1 x 2 world is one process -----------------------------------------

def test_one_by_two_world_is_bit_equal_to_one_process(tmp_path):
    """Adam (lr 1e-3) with dropout ON, 4 steps: a 1x2 world's losses,
    metrics and parameters bit-equal to one process's. Both ranks of the row
    draw the single process's dropout stream (the data index is folded in,
    not the rank); the optimizer's elementwise update over slices is the
    whole one's, and the gather is exact."""
    _, params, batches = _setup(DROPOUT)
    knobs = dict(lr=1e-3, optimizer="adam")
    phases = [{"model_parallel": 2, "batches": list(range(K_STEPS))}]
    ranks = _ranks(tmp_path, "train", _spec(knobs, phases, model=DROPOUT),
                   _arrays(params, batches), 2)
    _assert_ranks_agree(ranks)
    want, single, _ = _one_process(params, batches, knobs, model=DROPOUT)
    np.testing.assert_array_equal(ranks[0]["metrics"], want)
    for key, value in single.items():
        np.testing.assert_array_equal(ranks[0][f"param:{key}"], value, err_msg=key)


@pytest.mark.parametrize("world,mp,reduces", [(1, 1, 2), (2, 2, 0), (4, 2, 2)],
                         ids=["1x1", "1x2", "2x2"])
def test_the_data_axis_reduces_wherever_it_has_a_group(tmp_path, world, mp, reduces):
    """The train step's all_reduce runs once a step over the data axis'
    group: in a world of one too (its own group, so a one-card NCCL run
    drives it), and not on a 1 x 2 mesh, whose column is one rank."""
    _, params, batches = _setup(steps_=2)
    knobs = dict(lr=0.1, optimizer="sgd", momentum=0.0)
    phases = [{"model_parallel": mp, "batches": [0, 1]}]
    ranks = _ranks(tmp_path, "train", _spec(knobs, phases), _arrays(params, batches), world)
    assert [int(r["reduces"]) for r in ranks] == [reduces] * world


def test_the_row_agrees_where_its_replicated_grads_differ(tmp_path):
    """One sgd update (lr 0.1) over a 1x2 world whose rank 1 holds other
    grads of every replicated leaf than rank 0, as two column groups'
    reductions could round them: the ranks still end bit-equal, the
    replicated leaves' flat chunk m taken from model index m's update and
    each sharded leaf from the grads both ranks share."""
    _, params, batches = _setup(steps_=1)
    lr = 0.1
    ranks = _ranks(tmp_path, "torn", _spec(dict(lr=lr, optimizer="sgd", momentum=0.0), []),
                   _arrays(params, batches), 2)
    for key, value in _params(ranks[0]).items():
        np.testing.assert_array_equal(ranks[1][f"param:{key}"], value, err_msg=key)
    start = flatten_tree(params)

    def updated(r, key):  # the leaf after rank r's own sgd update
        return (torch.from_numpy(np.array(start[key]))
                + torch.from_numpy(ranks[r][f"grad:{key}"]) * -lr).numpy()

    replicated = [str(k) for k in ranks[0]["replicated"]]
    assert replicated and len(replicated) < len(start)
    flats = [np.concatenate([updated(r, k).ravel() for k in replicated]) for r in (0, 1)]
    assert not np.array_equal(flats[0], flats[1])
    chunk = -(-flats[0].size // 2)
    got = np.concatenate([ranks[0][f"param:{k}"].ravel() for k in replicated])
    np.testing.assert_array_equal(got, np.concatenate([flats[0][:chunk], flats[1][chunk:]]))
    for key in set(start) - set(replicated):
        np.testing.assert_array_equal(ranks[0][f"param:{key}"], updated(0, key), err_msg=key)


def test_an_axis_without_a_group_refuses_its_collectives():
    """A column or row of one rank in a larger world has no group; its
    collectives raise instead of running over the world (``group=None``)."""
    flat = torch.zeros(4)
    for mesh, calls in ((Mesh(data=2, model=1, group=object(), data_group=object()),
                         ("all_reduce_model_sum", "all_gather_model")),
                        (Mesh(data=1, model=2, group=object(), model_group=object()),
                         ("all_reduce_mean",))):
        for name in calls:
            with pytest.raises(RuntimeError, match="no (data|model) group"):
                getattr(mesh, name)(flat)


# -- 4. checkpoints that do not depend on the layout ---------------------------

@pytest.mark.parametrize("case", ["dp_to_tp", "tp_to_one_process"])
def test_checkpoint_resumes_across_layouts(tmp_path, case):
    """tests/test_multidevice_training.py::test_checkpoint_roundtrip_across_
    layouts's counterpart, sgd with momentum 0.9 (a trace to carry): 2 steps
    under one layout, save, restore under another, 2 more; the final
    parameters against the uninterrupted one-process run. ``dp_to_tp``: two
    processes as 2x1, then the same two as 1x2; ``tp_to_one_process``: 1x2,
    then the test's own process. The checkpoint holds whole arrays."""
    _, params, batches = _setup()
    knobs = dict(lr=0.1, optimizer="sgd", momentum=0.9)
    ckpt = str(tmp_path / "ckpt")
    first = {"model_parallel": 1 if case == "dp_to_tp" else 2, "batches": [0, 1], "save": ckpt}
    phases = [first] + ([{"model_parallel": 2, "batches": [2, 3], "restore": ckpt}]
                        if case == "dp_to_tp" else [])
    ranks = _ranks(tmp_path / "ranks", "train", _spec(knobs, phases),
                   _arrays(params, batches), 2)
    _assert_ranks_agree(ranks)
    _, want, _ = _one_process(params, batches, knobs)

    with np.load(os.path.join(ckpt, "epoch_0000", "opt_state.npz")) as npz:
        saved = {k: npz[k].shape for k in npz.files}
    trace = {k.split("/", 1)[1]: s for k, s in saved.items() if k.startswith("0/")}
    assert trace == {k: v.shape for k, v in want.items()}  # whole, whatever the layout
    if case == "dp_to_tp":
        got = _params(ranks[0])
    else:
        net = port_factory(dataclasses.asdict(MODEL), VOCAB, NANS, dim_v=DV, train=True)
        state = steps.create_state(net, optim.factory(OptimOptions(**knobs), 1))
        state, epoch = CheckpointManager(ckpt).restore(state, "latest")
        assert epoch == 0 and state.step == 2 and state.layout is None
        step = steps.make_train_step(optim.criterion_factory(), seed=0)
        for batch in batches[2:]:
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got = export_params(net)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **PARAM_TOL, err_msg=key)


# -- 5. the table row-sharded over the whole world -------------------------------

@pytest.mark.parametrize("world,mp", [(2, 2), (4, 2)], ids=["1x2", "2x2"])
def test_world_sharded_table_matches_the_replicated_one(tmp_path, world, mp):
    """11 images over every rank of the world (ceil(11 / ranks) rows each, the
    last with pad rows, then the sink): each rank's gathered rows bit-equal
    to the replicated table's, -0.0 features kept, and its eval step's pred
    and correct1 equal, for the float32 table and the int8 pair; the ranks
    of a row gather the same rows."""
    from vqa_tpu_torch.engine.steps import quantize_features

    _, params, batches = _setup()
    rng = np.random.default_rng(5)
    n_images = 11
    table = rng.standard_normal((n_images, R, DV)).astype(np.float32)
    table[::2, 0, :3] = -0.0
    values, scales = quantize_features(table)
    idx = rng.integers(0, n_images, B).astype(np.int32)
    idx[:4] = [0, 5, 6, 10]
    arrays = {f"param:{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    arrays.update(table=table, values=values, scales=scales, image_index=idx,
                  question=batches[0]["question"], length=batches[0]["length"],
                  answer=batches[0]["answer"])
    spec = dict(_spec({}, []), model_parallel=mp)
    ranks = _ranks(tmp_path, "sharded", spec, arrays, world)
    data = world // mp
    for rank, out in enumerate(ranks):
        for name in ("float32", "int8"):
            assert int(out[f"{name}:shard_rows"]) == -(-n_images // world) + 1
            got, want = out[f"{name}:got"], out[f"{name}:want"]
            assert got.shape == want.shape == (B // data, R, DV)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"rank {rank} {name}")
            np.testing.assert_array_equal(got, ranks[rank - rank % mp][f"{name}:got"])
            np.testing.assert_array_equal(out[f"{name}:shd_pred"], out[f"{name}:rep_pred"])
            assert int(out[f"{name}:shd_correct1"]) == int(out[f"{name}:rep_correct1"])
    assert np.signbit(ranks[0]["float32:got"][0, 0, :3]).all()


def test_dryrun_multigpu_with_a_model_axis(capsys):
    """flagship.dryrun_multigpu over 4 gloo ranks as a 2x2 mesh."""
    record = flagship.dryrun_multigpu(4, platform="cpu", timeout=RANK_TIMEOUT, model_parallel=2)
    assert record["mesh"] == {"data": 2, "model": 2, "data_index": 0, "model_index": 0,
                              "backend": "gloo"}
    assert record["sharded_leaves"] > 0
    assert record["steps"] == 5 and record["losses"][-1] < record["losses"][0]
    assert "dryrun_multigpu(4, tp=2): ok" in capsys.readouterr().out


def test_leaf_dim_is_the_jax_rule():
    """The rule's edges: 2-D only, the size threshold inclusive, the first
    of two equal dimensions, a dimension the axis does not divide."""
    assert leaf_dim((8, 8), 2, 64) == 0 and leaf_dim((8, 7), 2, 56) == 0
    assert leaf_dim((8, 7), 2, 57) is None and leaf_dim((7, 9), 2, 1) is None
    assert leaf_dim((6, 10), 2, 1) == 1 and leaf_dim((6, 10), 4, 1) is None
    assert leaf_dim((64,), 2, 1) is None and leaf_dim((4, 4, 4), 2, 1) is None
    assert leaf_dim((8, 8), 1, 1) is None


# -- 6. the train CLI on a model axis ------------------------------------------

CLI_OPT = os.path.join(REPO, "options", "vqa2", "concat_att.yaml")
# tests/test_torch_distributed.py's tiny dims, but an LSTM of 128 units: its
# wh [128, 512] reaches the CLI's default min_size, so the layout shards it
CLI_TINY = ["vqa.nans=20", "model.seq2vec.emb_size=12", "model.seq2vec.hidden_size=128",
            "model.attention.dim_h=12", "model.classif.dim_h=12"]


def test_cli_on_a_model_axis_resumes_in_one_process(tmp_path):
    """``python -m vqa_tpu_torch.cli.train --distributed`` as two gloo ranks
    with ``engine.model_parallel=2`` (a 1x2 mesh) for one epoch: both ranks
    name the mesh and print the same val acc1, the checkpoint holds adam's
    moments whole; one process resumes it for a second epoch, and its
    parameters equal an uninterrupted two-epoch run's within the JAX
    package's bounds."""
    from vqa_tpu_torch.cli import train as port_cli
    from vqa_tpu_torch.datasets.fixtures import generate

    d = str(tmp_path / "fix")
    generate(d, n_images=10, n_questions=64, seed=7)
    data = [f"vqa.dir={d}/vqa2", f"coco.dir={d}/coco"]
    common = ["--path_opt", CLI_OPT, "--platform", "cpu", "--batch_size", "16"] + \
        [a for o in data + CLI_TINY for a in ("--opt", o)]
    tp, plain = str(tmp_path / "tp"), str(tmp_path / "plain")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "vqa_tpu_torch.cli.train"] + common
                              + ["--dir_logs", tp, "--epochs", "1", "--distributed",
                                 "--opt", "engine.model_parallel=2", "--coordinator_address",
                                 f"file://{tmp_path}/store", "--num_processes", "2",
                                 "--process_id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"rank {r} of 2 over gloo, mesh 1 x 2 (data x model)" in out
    evals = [[line.split(" (")[0] for line in out.splitlines() if line.startswith("Eval [")]
             for out in outs]  # the QA/s aside
    assert len(evals[0]) == 1 and evals[0] == evals[1]

    ckpt = os.path.join(tp, "ckpt", "epoch_0000")
    with np.load(os.path.join(ckpt, "params.npz")) as npz:
        shapes = {k: npz[k].shape for k in npz.files}
    with np.load(os.path.join(ckpt, "opt_state.npz")) as npz:
        moments = {k: npz[k].shape for k in npz.files if k.startswith(("0/mu/", "0/nu/"))}
    assert moments == {f"0/{m}/{k}": s for m in ("mu", "nu") for k, s in shapes.items()}
    picks = tp_shardings(shapes, Mesh(model=2))
    assert picks["encoder/lstm_0/wh"] == 1 and sum(d is not None for d in picks.values()) >= 1

    assert port_cli.main(common + ["--dir_logs", tp, "--resume", "latest", "--epochs", "2"]) == 0
    assert port_cli.main(common + ["--dir_logs", plain, "--epochs", "2"]) == 0
    with np.load(os.path.join(tp, "ckpt", "epoch_0001", "params.npz")) as got, \
            np.load(os.path.join(plain, "ckpt", "epoch_0001", "params.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_allclose(got[key], want[key], **PARAM_TOL, err_msg=key)
