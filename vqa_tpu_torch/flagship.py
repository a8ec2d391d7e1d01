"""The flagship model: MutanAtt at ``options/vqa2/mutan_att.yaml`` dims, the
port's counterpart of ``__graft_entry__._flagship_model`` and ``entry``;
beside it the model sections of the other configs under ``options/vqa2``
(``CONFIGS``: ConcatAtt, MLBAtt, MutanNoAtt, MLBNoAtt, MFB and MFH
co-attention, CoR), each with its answer count, and two variants no YAML
holds (``VARIANTS``): ConcatNoAtt (MLBNoAtt's model with a concat fusion)
and MutanAtt with the skip-thoughts encoder (a 620 -> 2400 GRU, the MUTAN
paper's question encoder). ``dryrun_multigpu`` is the counterpart of
``__graft_entry__.dryrun_multichip`` without tensor parallelism.

The model sections are kept here as dicts so the GPU path builds the
models without a YAML parser; tests/test_torch_weights.py holds each equal
to ``load_options("options/vqa2/<name>.yaml").model`` (and the answer
count to its ``vqa.nans``), and each variant to its YAML with the
overrides it names.
"""

from __future__ import annotations

import copy
import queue
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from vqa_tpu_torch.models.factory import factory

NUM_WORDS = 12_000
NUM_ANSWERS = 2_000

MODEL = {
    "arch": "MutanAtt",
    "seq2vec": {"arch": "lstm", "emb_size": 620, "hidden_size": 2400, "num_layers": 1,
                "dropout": 0.0},
    "attention": {
        "nb_glimpses": 2, "dim_hv": 310, "dim_hq": 310, "dim_mm": 510, "R": 5,
        "dropout_v": 0.5, "dropout_q": 0.5, "dropout_mm": 0.5, "dropout_hv": 0.0,
        "dropout_hq": 0.0, "activation_v": "tanh", "activation_q": "tanh",
    },
    "fusion": {
        "arch": "mutan", "dim_hv": 620, "dim_hq": 310, "dim_mm": 510, "R": 5,
        "dropout_v": 0.5, "dropout_q": 0.5, "dropout_hv": 0.0, "dropout_hq": 0.0,
        "activation_v": "tanh", "activation_q": "tanh",
    },
    "classif": {"dropout": 0.5},
    "pretrained_params": None,
    "extra": {},
}

_MFB_SEQ2VEC = {"arch": "lstm", "emb_size": 300, "hidden_size": 1024, "num_layers": 1,
                "dropout": 0.3, "return_sequence": True}
_MFB_ATTENTION = {"nb_glimpses": 2, "dim_h": 512, "dropout": 0.1, "question_glimpses": 2}

_NOATT_SEQ2VEC = {"arch": "lstm", "emb_size": 620, "hidden_size": 2400, "num_layers": 1}

# name -> (model section, num_answers), for options/vqa2/<name>.yaml
CONFIGS = {
    "mutan_att": (MODEL, NUM_ANSWERS),
    "concat_att": ({
        "arch": "ConcatAtt",
        "seq2vec": {"arch": "lstm", "emb_size": 620, "hidden_size": 1024, "num_layers": 1,
                    "dropout": 0.0},
        "attention": {"nb_glimpses": 1, "dim_h": 1024, "dropout_v": 0.5, "dropout_q": 0.5,
                      "dropout_mm": 0.5, "activation": "tanh"},
        "fusion": {"arch": "concat", "dropout_v": 0.5, "dropout_q": 0.5},
        "classif": {"dim_h": 1024, "dropout": 0.5},
        "pretrained_params": None,
        "extra": {},
    }, 2_000),
    "mlb_att": ({
        "arch": "MLBAtt",
        "seq2vec": {"arch": "lstm", "emb_size": 620, "hidden_size": 2400, "num_layers": 1,
                    "dropout": 0.0},
        "attention": {"nb_glimpses": 2, "dim_h": 1200, "dropout_v": 0.5, "dropout_q": 0.5,
                      "dropout_mm": 0.0, "activation": "tanh"},
        "fusion": {"arch": "mlb", "dim_h": 1200, "dropout_v": 0.5, "dropout_q": 0.5,
                   "activation_v": "tanh", "activation_q": "tanh"},
        "classif": {"dropout": 0.5},
        "pretrained_params": None,
        "extra": {},
    }, 2_000),
    "mutan_noatt": ({
        "arch": "MutanNoAtt",
        "seq2vec": _NOATT_SEQ2VEC,
        "attention": {},
        "fusion": {"arch": "mutan", "dim_hv": 620, "dim_hq": 310, "dim_mm": 510, "R": 5,
                   "dropout_v": 0.5, "dropout_q": 0.5},
        "classif": {"dropout": 0.5},
        "pretrained_params": None,
        "extra": {},
    }, 2_000),
    "mlb_noatt": ({
        "arch": "MLBNoAtt",
        "seq2vec": _NOATT_SEQ2VEC,
        "attention": {},
        "fusion": {"arch": "mlb", "dim_h": 1200, "dropout_v": 0.5, "dropout_q": 0.5},
        "classif": {"dropout": 0.5},
        "pretrained_params": None,
        "extra": {},
    }, 2_000),
    "mfb_coatt": ({
        "arch": "MFBCoAtt",
        "seq2vec": _MFB_SEQ2VEC,
        "attention": _MFB_ATTENTION,
        "fusion": {"arch": "mfb", "pool_factor": 5, "dim_mm": 1000, "dropout_pre": 0.1},
        "classif": {"dropout": 0.1},
        "pretrained_params": None,
        "extra": {},
    }, 2_000),
    "mfh_coatt": ({
        "arch": "MFHCoAtt",
        "seq2vec": _MFB_SEQ2VEC,
        "attention": _MFB_ATTENTION,
        "fusion": {"arch": "mfh", "pool_factor": 5, "dim_mm": 1000, "mfh_order": 2,
                   "dropout_pre": 0.1},
        "classif": {"dropout": 0.1},
        "pretrained_params": None,
        "extra": {},
    }, 2_000),
    "cor": ({
        "arch": "CoR",
        "seq2vec": {"arch": "lstm", "emb_size": 620, "hidden_size": 1024, "num_layers": 1,
                    "dropout": 0.0},
        "attention": {"dim_h": 512, "dropout": 0.2},
        "fusion": {"arch": "cor", "dim_h": 1024, "dropout": 0.2},
        "classif": {"dim_h": 1024, "dropout": 0.5},
        "pretrained_params": None,
        "extra": {"chain": {"steps": 3}},
    }, 3_000),
}

# name -> (the config it derives from, the model-section keys it replaces):
# the same as `--opt model.<key>=<value>` for each on that config's YAML
VARIANTS = {
    "concat_noatt": ("mlb_noatt", {"arch": "ConcatNoAtt", "fusion": {
        "arch": "concat", "dropout_v": 0.5, "dropout_q": 0.5}}),
    "mutan_att_skipthoughts": ("mutan_att", {"seq2vec": {
        **MODEL["seq2vec"], "arch": "skipthoughts"}}),
}

# the tiny variant of __graft_entry__._flagship_model(tiny=True)
_TINY = {
    "seq2vec": {"emb_size": 16, "hidden_size": 32},
    "attention": {"dim_hv": 12, "dim_hq": 12, "dim_mm": 16, "R": 2},
    "fusion": {"dim_hv": 12, "dim_hq": 12, "dim_mm": 16, "R": 2},
}


def answer_count(name: str) -> int:
    """The answer count of a config or a variant."""
    return CONFIGS[VARIANTS[name][0] if name in VARIANTS else name][1]


def model_options(tiny: bool = False, name: str = "mutan_att") -> dict:
    """A fresh copy of a config's or a variant's model section (``tiny``
    only for the flagship)."""
    if name in VARIANTS:
        base, changes = VARIANTS[name]
        return {**model_options(name=base), **copy.deepcopy(changes)}
    opt = copy.deepcopy(CONFIGS[name][0])
    if tiny:
        for section, values in _TINY.items():
            opt[section].update(values)
    return opt


def build(num_words: int = NUM_WORDS, num_answers: int = NUM_ANSWERS, tiny: bool = False,
          dtype=torch.float32, device="cuda", dim_v: int = 2048):
    return factory(model_options(tiny), num_words, num_answers, dtype=dtype, device=device,
                   dim_v=dim_v)


def build_config(name: str, num_words: int = NUM_WORDS, dtype=torch.float32, device="cuda",
                 dim_v: int = 2048):
    """The model of ``options/vqa2/<name>.yaml`` (or of a variant) at full
    width, with its own answer count."""
    return factory(model_options(name=name), num_words, answer_count(name), dtype=dtype,
                   device=device, dim_v=dim_v)


def example_batch(batch: int = 64, seq: int = 26, regions: int = 36, dim: int = 2048,
                  num_words: int = NUM_WORDS, seed: int = 0) -> dict:
    """The seeded forward inputs of ``__graft_entry__.entry`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "visual": rng.standard_normal((batch, regions, dim)).astype(np.float32),
        "question": rng.integers(1, num_words, (batch, seq)).astype(np.int32),
        "length": np.full((batch,), seq, np.int32),
    }


def _dryrun_rank(rank: int, n: int, model_parallel: int, store: str, platform: str,
                 results) -> None:
    """One rank of ``dryrun_multigpu``: puts ``(rank, record)`` or ``(rank,
    traceback)`` on ``results``."""
    try:
        from vqa_tpu_torch import parallel
        from vqa_tpu_torch.config import OptimOptions
        from vqa_tpu_torch.engine import optim, steps
        from vqa_tpu_torch.parallel.mesh import local_rows
        from vqa_tpu_torch.parallel.partition import shard_state_tp
        from vqa_tpu_torch.weights import init_params

        if platform == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        device = parallel.initialize(store, n, rank, device=platform)
        try:
            mesh = parallel.make_mesh(model_parallel)
            num_words, num_answers = 50, 17
            batch, seq, regions, dim, n_images = 4 * n, 8, 6, 32, 10
            rng = np.random.default_rng(0)
            question = rng.integers(1, num_words, (batch, seq)).astype(np.int32)
            lengths = rng.integers(1, seq + 1, batch).astype(np.int32)
            table = rng.standard_normal((n_images, regions, dim)).astype(np.float32)
            image_index = rng.integers(0, n_images, batch).astype(np.int32)
            answers = rng.integers(0, num_answers, batch).astype(np.int32)
            lo, hi = local_rows(batch, mesh)
            local = {"question": torch.from_numpy(question[lo:hi]).to(device),
                     "length": torch.from_numpy(lengths[lo:hi]).to(device),
                     "answer": torch.from_numpy(answers[lo:hi]).to(device),
                     "image_index": image_index[lo:hi]}
            model = factory(model_options(tiny=True), num_words, num_answers, device=device,
                            dim_v=dim, train=True)
            init_params(model, 0)
            # the tiny dims and a visible lr, as the JAX dryrun's: the fixed
            # batch's loss falls past the dropout's noise; its min_size, so
            # the tiny leaves shard over the model axis
            state = shard_state_tp(
                steps.create_state(model, optim.factory(OptimOptions(lr=0.01), 1)), mesh,
                min_size=64)
            features = parallel.shard_feature_table(torch.from_numpy(table), mesh, device)
            train_step = steps.make_train_step(optim.criterion_factory(), seed=1, mesh=mesh)
            losses = []
            for _ in range(5):  # the same batch each step: the loss must fall
                state, metrics = train_step(state, local, features)
                losses.append(float(metrics["loss"]))
            out = steps.make_eval_step()(state.model, local, features)
            record = dict(losses=losses, steps=state.step, pred=out["pred"].cpu().tolist(),
                          n=int(out["n"]), sharded_leaves=len(state.layout.sharded)
                          if state.layout is not None else 0,
                          mesh=dict(data=mesh.data, model=mesh.model,
                                    data_index=mesh.data_index, model_index=mesh.model_index,
                                    backend=mesh.backend))
        finally:
            parallel.shutdown()
        results.put((rank, record))
    except Exception:  # the boundary of a worker process: report, then exit
        results.put((rank, traceback.format_exc()))


def dryrun_multigpu(n_processes: int, platform: str = "cuda", timeout: float = 600.0,
                    model_parallel: Optional[int] = None) -> dict:
    """Training over ``n_processes`` spawned ranks on the mesh
    ``n / model_parallel × model_parallel`` (default: 2 on an even world of
    at least 4, else 1, as ``__graft_entry__.dryrun_multichip``) at tiny
    MutanAtt dims: 5 steps on one fixed batch of ``4 * n`` rows (each data
    index its slice), the optimizer state sharded over the model axis
    (``min_size`` 64, the JAX dryrun's), over a feature table row-sharded
    over every rank, adam at lr 0.01 with the YAML's dropout, then one eval
    step over the sharded table. Holds: every rank reports the same
    (globally reduced) losses, finite and lower after the 5 steps, the ranks
    of a row the same eval slice, and the data indices' slices cover the
    batch with answers in range. ``platform`` is where the ranks run
    (``"cpu"``: over gloo on the host; the card: over NCCL, one card a
    rank). Returns rank 0's record."""
    if model_parallel is None:
        model_parallel = 2 if n_processes % 2 == 0 and n_processes >= 4 else 1
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dryrun_multigpu_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n_processes, model_parallel, f"file://{tmp}/store",
                                   platform, results))
                 for r in range(n_processes)]
        for p in procs:
            p.start()
        records = {}
        deadline = time.monotonic() + timeout
        try:
            while len(records) < n_processes:
                try:
                    rank, record = results.get(timeout=1.0)
                    records[rank] = record
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        raise RuntimeError(f"dryrun_multigpu({n_processes}): ranks ended "
                                           f"{dead} or timed out with {sorted(records)} done")
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    failed = {r: rec for r, rec in records.items() if isinstance(rec, str)}
    if failed:
        raise RuntimeError(f"dryrun_multigpu({n_processes}): ranks failed:\n"
                           + "\n".join(f"[rank {r}]\n{tb}" for r, tb in sorted(failed.items())))
    first = records[0]
    losses = first["losses"]
    if any(rec["losses"] != losses for rec in records.values()):
        raise AssertionError(f"the ranks disagree on the global losses: {records}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall over 5 steps on a fixed batch: {losses}")
    rows = [records[r] for r in range(0, n_processes, model_parallel)]  # model index 0
    pred = [a for rec in rows for a in rec["pred"]]
    if any(rec["pred"] != records[r - r % model_parallel]["pred"] for r, rec in records.items()) \
            or sum(rec["n"] for rec in rows) != 4 * n_processes \
            or not all(0 <= a < 17 for a in pred) or first["steps"] != 5 \
            or (model_parallel > 1) != (first["sharded_leaves"] > 0):
        raise AssertionError(f"the sharded eval step's slices or the layout: {records}")
    mesh = first["mesh"]
    print(f"dryrun_multigpu({n_processes}, tp={model_parallel}): ok, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over 5 steps + one sharded eval step, mesh {mesh['data']} x "
          f"{mesh['model']} (data x model) over {mesh['backend']}, batch sharded over "
          f"'data', {first['sharded_leaves']} leaves' optimizer state over 'model', feature "
          "table row-sharded over every rank", flush=True)
    return first
