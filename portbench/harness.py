"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference.

The program is ``vqa_tpu_torch``, driven through its own entry points as
its CLI drives them: the dataset and ``BatchIterator`` over a split made
from the seed, ``engine.make_device_transform``, the model factory, and
``engine.validate`` with ``steps.make_eval_step()`` (eval cells) or
``engine.train`` with ``steps.make_train_step`` and adam (train cells).
The harness wraps the loader (the host time of each ``next``, a stop at
the window's end) and the train step (its host time) but changes neither.

An eval window runs whole epochs back to back from the first after the
warm-up epoch, and ends at the first epoch boundary past ``seconds``. A
train window starts at an epoch's first step and ends at the first step
boundary past ``seconds``; its partial epoch still reads its metrics back.
Both end after ``torch.cuda.synchronize()``. A traced run then profiles one
more epoch (eval) or ``traced_steps`` more steps (train) in the same
process, so the window's own numbers carry no profiler.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import statistics
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import flops, plugins, traffic as traffic_lib
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train
from portbench.reference.params import SAMPLE, derive, make_params, param_spec
from portbench.spec import Cell
from portbench.trace import Trace

REF_BLOCK = 1024  # questions a reference call takes


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def annotate(name: str):
    return torch.profiler.record_function(f"portbench.{name}")


class TimedLoader:
    """A ``BatchIterator`` as ``engine.validate`` and ``engine.train`` take
    it, with the host time of each ``next`` recorded, the model FLOPs of
    each batch's real questions counted, and an optional stop: before a
    batch once ``deadline`` has passed (on any rank, by ``agree``), or after
    ``max_batches``."""

    def __init__(self, inner, flops_of_batch, agree=None):
        self.inner = inner
        self.flops_of_batch = flops_of_batch
        self.agree = agree or (lambda past: past)   # across ranks: any rank past it
        self.stopped = False
        self.waits: List[float] = []
        self.flops = 0.0
        self.batches: List[dict] = []      # host keys of the batches, while ``keep``
        self.keep = False
        self.deadline: Optional[float] = None
        self.max_batches: Optional[int] = None
        self.last_yield = 0.0

    def steps_per_epoch(self) -> int:
        return self.inner.steps_per_epoch()

    def epoch(self, epoch: int = 0):
        it = self.inner.epoch(epoch)
        n = 0
        try:
            while self.max_batches is None or n < self.max_batches:
                if self.deadline is not None and self.agree(time.perf_counter() >= self.deadline):
                    self.stopped = True
                    return
                t = time.perf_counter()
                with annotate("loader_next"):
                    batch = next(it, None)
                if batch is None:
                    return
                self.waits.append(time.perf_counter() - t)
                self.flops += self.flops_of_batch(batch)
                if self.keep:
                    self.batches.append({"question_id": batch["question_id"],
                                         "answer": batch.get("answer")})
                n += 1
                self.last_yield = time.perf_counter()
                yield batch
        finally:
            it.close()


class TimedStep:
    """The train step, its host time per call recorded; ``after`` sees the
    call count, the state and the metrics after each call."""

    def __init__(self, fn):
        self.fn = fn
        self.host: List[float] = []
        self.calls = 0
        self.after = None

    def __call__(self, state, batch, features=None):
        t = time.perf_counter()
        with annotate("train_step"):
            state, metrics = self.fn(state, batch, features)
        self.host.append(time.perf_counter() - t)
        self.calls += 1
        if self.after is not None:
            self.after(self.calls, state, metrics)
        return state, metrics


@dataclasses.dataclass
class Run:
    """What a run measured, for the per-layer readers and the result."""

    cell: Cell
    seconds: float = 0.0                 # the window's wall time
    questions: int = 0                   # QA pairs evaluated or trained in the window
    model_flops: float = 0.0             # of the window's questions at their own lengths
    loader_waits: List[float] = dataclasses.field(default_factory=list)
    epoch_tails: List[float] = dataclasses.field(default_factory=list)
    step_host: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None         # host and device, the ops' shapes recorded
    device_trace: Optional[Trace] = None  # the device alone
    setup_s: float = 0.0
    memory_peak: int = 0
    gc: List[int] = dataclasses.field(default_factory=list)   # collections in the window
    epoch_seconds: List[float] = dataclasses.field(default_factory=list)   # eval epochs' times
    host: Dict[str, float] = dataclasses.field(default_factory=dict)   # host_counters' growth
    traced_steps: int = 0                # train steps in each traced stretch
    checks: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    info: Dict[str, float] = dataclasses.field(default_factory=dict)


def host_counters() -> Dict[str, float]:
    """What the host spent: this process's CPU seconds, all its threads."""
    import resource

    use = resource.getrusage(resource.RUSAGE_SELF)
    return {"process_cpu_s": use.ru_utime + use.ru_stime}


def _quiet():
    """The program's progress lines go to standard error: the result is the
    last line of standard output."""
    return contextlib.redirect_stdout(sys.stderr)


def _program_split(data: Dict[str, np.ndarray], traffic: dict, cfg: dict, train: bool):
    """The split as the program's dataset: its processed arrays, vocabularies
    and a feature store of the table's shape (the rows live on the card)."""
    from vqa_tpu_torch.config import VQAOptions
    from vqa_tpu_torch.datasets.features import FeatureStore
    from vqa_tpu_torch.datasets.processed import ProcessedSplit, Vocabs
    from vqa_tpu_torch.datasets.vqa2 import VQA2Dataset

    t = traffic["table"]
    names = np.asarray([f"img{i}" for i in range(traffic["split"]["images"])])
    split = ProcessedSplit(data["question_ids"], data["questions"], data["lengths"],
                           names[data["image_index"]], data["answers"], data["answer_pool"])
    vocabs = Vocabs([f"w{i}" for i in range(cfg["num_words"])],
                    [f"a{i}" for i in range(cfg["num_answers"])])
    shape = np.broadcast_to(np.zeros((), np.float32), (len(names), t["regions"], t["dim"]))
    store = FeatureStore.in_memory(names.tolist(), shape)
    opt = VQAOptions(maxlength=traffic["maxlength"], pad="right",
                     samplingans=bool(traffic.get("samplingans", False)))
    return VQA2Dataset(split, vocabs, store, opt, "train" if train else "val",
                       sampling=opt.samplingans and train, visual_mode="index")


def _load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    params = {n.replace(".", "/"): p for n, p in model.named_parameters()}
    if set(params) != set(weights):
        raise KeyError(f"the program's parameters differ from the reference's: "
                       f"{sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program's {tuple(p.shape)}, "
                                 f"the reference's {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def _profile(device, host: bool):
    """A profiler of the card's kernels and, with ``host``, of the host's
    ops with their shapes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, record_shapes=host)


def _read_trace(prof, device, window_us: Optional[float] = None) -> Trace:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = Trace.load(path, window_us)
    if device.type == "cuda" and not trace.kernels:
        raise RuntimeError("the profiler recorded no kernel on the card in the traced window")
    return trace


class Harness:
    def __init__(self, cell: Cell, seed: int, device, process_start: float, mesh=None):
        """``mesh``: this rank's ``parallel.mesh.Mesh`` where the cell spans
        several cards, one process a card; rank 0 reports."""
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mesh = mesh
        self.world = mesh.size if mesh is not None else 1
        self.primary = mesh is None or mesh.rank == 0
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.train = self.traffic["kind"] == "train"
        self.run = Run(cell)
        self.t0 = self.last_mark = process_start
        self.phases: Dict[str, float] = {}
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.tables = plugins.load("tables", self.traffic["table"]["kind"])

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from vqa_tpu_torch.config import OptimOptions
        from vqa_tpu_torch.datasets.pipeline import BatchIterator, normalize_buckets
        from vqa_tpu_torch.engine import engine, optim, steps
        from vqa_tpu_torch.models.factory import factory

        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.mark("imports")
        self.data = traffic_lib.generate(tr, cfg["num_words"], cfg["num_answers"], self.seed)
        self.mark("split")
        self.table = self.tables.make(tr, self.seed, dev, self.mesh)
        sync(dev)
        self.mark("table")
        dim_v = tr["table"]["dim"]
        weights = make_params(param_spec(cfg, dim_v), self.seed, dev)
        self.model = factory(cfg["model"], cfg["num_words"], cfg["num_answers"],
                             dtype=self.dtype, device=dev, dim_v=dim_v, train=self.train)
        _load_weights(self.model, weights)
        del weights
        sync(dev)
        self.mark("model")
        per_length = np.asarray(flops.flops_by_length(cfg, tr["maxlength"], tr["table"]["regions"],
                                                      dim_v, self.train))
        lengths = self.data["lengths"]

        def flops_of_batch(batch) -> float:
            rows = batch["question_id"]
            if batch.get("valid_host") is not None:
                rows = rows[batch["valid_host"]]
            return float(per_length[lengths[rows]].sum())

        dataset = _program_split(self.data, tr, cfg, self.train)
        ladder = normalize_buckets(tr["buckets"], tr["maxlength"]) if tr.get("buckets") else None
        input_dtype = None if self.dtype == torch.float32 else self.dtype
        transform = engine.make_device_transform(dev, input_dtype)
        if self.train:
            # as the CLI: each data rank its shard of the split at its share
            # of the global batch; length bucketing only in one process
            shards = (dict(shard_index=self.mesh.data_index, shard_count=self.mesh.data,
                           shard_even=True) if self.world > 1 else {})
            buckets = (dict(bucket_window=tr["bucket_window"], length_buckets=ladder)
                       if tr.get("bucket_window") else {})
            inner = BatchIterator(dataset, tr["batch"] // self.world, shuffle=True,
                                  seed=self.seed, drop_last=True, transform=transform,
                                  **shards, **buckets)
            tx = optim.factory(OptimOptions(**cfg["optim"], batch_size=tr["batch"]),
                               inner.steps_per_epoch())
            self.state = steps.create_state(self.model, tx)
            self.step = TimedStep(steps.make_train_step(optim.criterion_factory(), self.seed,
                                                        mesh=self.mesh))
        else:
            inner = BatchIterator(dataset, tr["batch"], shuffle=False, pad_last=True,
                                  transform=transform, sort_by_length=True, length_buckets=ladder)
            self.eval_step = steps.make_eval_step()
            self.aid_to_ans = dataset.vocabs.aid_to_ans
        self.loader = TimedLoader(inner, flops_of_batch, self._any_rank)
        self.dataset = dataset
        self.mark("loader")
        with _quiet():
            self._train_first_steps() if self.train else self._eval_epoch(0)
        self.loader.waits.clear()
        self.loader.flops = 0.0
        sync(dev)
        self.mark("warm-up")
        self.run.setup_s = time.time() - self.t0
        print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in self.phases.items()),
              file=sys.stderr, flush=True)

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` or-ed over the ranks (one host collective), alone in one
        process."""
        if self.world == 1:
            return flag
        return bool(self.mesh.all_gather_host(np.array([int(flag)], np.int64)).any())

    def _gather(self, array: np.ndarray) -> np.ndarray:
        """Every rank's ``array`` concatenated in rank order (one process:
        its own)."""
        if self.world == 1:
            return array
        return self.mesh.all_gather_host(np.ascontiguousarray(array)).reshape(
            (-1,) + array.shape[1:])

    def mark(self, phase: str) -> None:
        """Close a phase of the set-up on the host clock."""
        now = time.time()
        self.phases[phase] = now - self.last_mark
        self.last_mark = now

    def _eval_epoch(self, epoch: int):
        from vqa_tpu_torch.engine import engine

        with annotate("validate"):
            _, results = engine.validate(self.loader, self.model, self.eval_step,
                                         self.aid_to_ans, None, epoch, features=self.table)
        return results

    def _train_epoch(self, epoch: int):
        from vqa_tpu_torch.engine import engine

        self.state, _ = engine.train(self.loader, self.state, self.step, None, epoch,
                                     self.traffic["print_freq"] if self.primary else 0,
                                     features=self.table)

    def _train_first_steps(self) -> None:
        """The checked steps, on the one train state that the window then
        takes: the first ``checked_steps`` steps of epoch 0 through the
        window's own loader and step, then one step on each length bucket
        they did not reach, through the same step (so every bucket the
        window runs is checked). Kept for the check: each step's batch, its
        length bucket, its loss and each leaf's norm of its gradient as adam
        got it (from adam's first moment before and after the step), and
        the parameters after the last."""
        from vqa_tpu_torch.datasets.pipeline import BatchIterator, normalize_buckets

        kept: Dict[str, Any] = {"loss": [], "grad_norms": []}
        names = [n_.replace(".", "/") for n_, p in self.model.named_parameters()
                 if p.requires_grad]
        previous: List[Optional[torch.Tensor]] = [None] * len(names)
        b1 = ref_train.B1

        def after(calls, state, metrics):
            kept["loss"].append(metrics["loss"].detach().float().clone())
            adam = next(s for s in state.opt_state if hasattr(s, "mu"))
            grads = [(m.float() if p_ is None else m.float() - b1 * p_) / (1 - b1)
                     for m, p_ in zip(adam.mu, previous)]
            kept["grad_norms"].append(torch.stack([g.norm() for g in grads]))
            previous[:] = [m.detach().float().clone() for m in adam.mu]

        tr = self.traffic
        self.step.after = after
        self.loader.keep, self.loader.max_batches = True, tr["checked_steps"]
        self._train_epoch(0)
        self.loader.keep, self.loader.max_batches = False, None
        # the global batches, the data ranks' shards in rank order
        batches = [{"question_id": self._gather(b["question_id"]),
                    "answer": self._gather(b["answer"].cpu().numpy())}
                   for b in self.loader.batches]
        ladder = (normalize_buckets(tr["buckets"], tr["maxlength"]) if tr.get("buckets")
                  else (tr["maxlength"],))
        lengths = self.data["lengths"]

        def bucket(rows) -> int:
            return next(x for x in ladder if x >= int(lengths[rows].max()))

        if tr.get("bucket_window"):
            seen = {bucket(b["question_id"]) for b in batches}
            rows = []
            for lo, hi in zip((0,) + tuple(ladder[:-1]), ladder):
                if hi in seen:
                    continue
                pick = np.nonzero((lengths > lo) & (lengths <= hi))[0][: tr["batch"]]
                if len(pick) == tr["batch"]:
                    rows.append(pick)
                elif len(pick):   # too few of this length: the longest questions
                    rows.append(np.argsort(lengths, kind="stable")[-tr["batch"]:])
            if rows:
                warm = _program_split({k: v[np.concatenate(rows)] for k, v in self.data.items()},
                                      tr, self.cfg, True)
                inner = BatchIterator(warm, tr["batch"], shuffle=False, drop_last=True,
                                      transform=self.loader.inner.transform,
                                      sort_by_length=True, length_buckets=ladder)
                warm_loader = TimedLoader(inner, lambda batch: 0.0)
                warm_loader.keep = True
                from vqa_tpu_torch.engine import engine

                self.state, _ = engine.train(warm_loader, self.state, self.step, None, 0, 0,
                                             features=self.table)
                batches += [{"question_id": b["question_id"], "answer": b["answer"].cpu().numpy()}
                            for b in warm_loader.batches]
        self.step.after = None
        del previous[:]
        kept["grad_norms"] = [dict(zip(names, n.tolist())) for n in kept["grad_norms"]]
        kept["params"] = [p.detach().clone() for p in self.state.params]
        kept.update(batches=batches, names=names,
                    buckets=[bucket(b["question_id"]) for b in batches])
        self.first = kept
        self.step.host.clear()

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> None:
        from vqa_tpu_torch.parallel import distributed

        run, dev = self.run, self.device
        sync(dev)
        distributed.barrier()
        collections = [g["collections"] for g in gc.get_stats()]
        host0 = host_counters()
        start = time.perf_counter()
        with _quiet():
            if self.train:
                self.loader.deadline = start + seconds
                calls0, epoch = self.step.calls, 1
                while not self.loader.stopped:
                    self._train_epoch(epoch)
                    epoch += 1
                self.loader.deadline = None
                steps = self.step.calls - calls0
                run.questions = steps * self.traffic["batch"]
                self.next_epoch = epoch
            else:
                epoch = 1
                while True:
                    begun = time.perf_counter()
                    self.results = self._eval_epoch(epoch)
                    run.epoch_seconds.append(time.perf_counter() - begun)
                    run.epoch_tails.append(time.perf_counter() - self.loader.last_yield)
                    run.questions += len(self.results)
                    epoch += 1
                    if time.perf_counter() - start >= seconds:
                        break
                self.next_epoch = epoch
        sync(dev)
        run.seconds = time.perf_counter() - start
        run.gc = [g["collections"] - c for g, c in zip(gc.get_stats(), collections)]
        run.host = {k: v - host0[k] for k, v in host_counters().items()}
        parts = self.step.host if self.train else run.epoch_seconds
        quartiles = statistics.quantiles(parts, n=4) if len(parts) > 1 else parts
        print(f"window: {run.seconds:.3f} s, {run.questions} questions, the interpreter's "
              f"garbage collections by generation {run.gc}; "
              f"{'step host' if self.train else 'epoch'} time quartiles (s) {quartiles}; "
              f"host counters { {k: round(v, 3) for k, v in run.host.items()} }",
              file=sys.stderr, flush=True)
        run.model_flops = float(self._gather(np.array([self.loader.flops])).sum())
        run.loader_waits = list(self.loader.waits)
        run.step_host = list(self.step.host) if self.train else []
        if dev.type == "cuda":   # the fullest card's
            run.memory_peak = int(self._gather(np.array([torch.cuda.max_memory_allocated(dev)]))
                                  .max())

    def traced(self) -> None:
        """Two traced stretches after the window, each one more epoch (eval)
        or ``traced_steps`` more steps (train): the device alone, the
        profiler's host side off so that its cost lengthens no gap (busy
        and idle time, the kernels' times); then host and device, the ops'
        shapes recorded (the ops' kernels, the launches a step, what the
        host did in each gap), bounded by the span ``portbench.traced``."""
        dev = self.device
        device_prof, full_prof = _profile(dev, host=False), _profile(dev, host=True)
        marks: Dict[str, Any] = {}

        def begin_device():
            sync(dev)
            if self.primary:   # rank 0 is traced; the others keep its pace
                device_prof.start()
            marks["t0"] = time.perf_counter()

        def end_device():
            sync(dev)
            wall = time.perf_counter() - marks["t0"]
            if self.primary:
                device_prof.stop()
                # read before the next profiler starts: it clears this one's events
                self.run.device_trace = _read_trace(device_prof, dev, wall * 1e6)

        def begin_full():
            if self.primary:
                full_prof.start()
                marks["span"] = annotate("traced")
                marks["span"].__enter__()

        def end_full():
            sync(dev)
            if self.primary:
                marks["span"].__exit__(None, None, None)
                full_prof.stop()

        with _quiet():
            if self.train:
                skip, count = self.traffic["traced_steps"]
                self.run.traced_steps = count
                at = self.step.calls + skip
                hooks = {at: (begin_device,), at + count: (end_device, begin_full),
                         at + 2 * count: (end_full,)}
                self.step.after = lambda calls, state, metrics: [f() for f in
                                                                 hooks.get(calls, ())]
                self.loader.max_batches = skip + 2 * count
                self._train_epoch(self.next_epoch)
                self.loader.max_batches = None
                self.step.after = None
            else:
                begin_device()
                self._eval_epoch(self.next_epoch)
                end_device()
                begin_full()
                self._eval_epoch(self.next_epoch + 1)
                end_full()
        if self.primary:
            self.run.trace = _read_trace(full_prof, dev)
            print("device time by class (ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in self.run.device_trace.by_class().items()),
                file=sys.stderr, flush=True)

    # -- the check ------------------------------------------------------------

    def free_program(self) -> None:
        """Drop the program's state; a row shard of the table goes too (the
        reference rebuilds the rows it needs from the seed)."""
        for name in ("model", "state", "loader", "dataset", "eval_step", "step"):
            if hasattr(self, name):
                delattr(self, name)
        if not isinstance(getattr(self, "table", None), torch.Tensor):
            self.table = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, tuple]:
        """The numbers compared with the plain reference, each with its
        limit; a reading the cell sets no limit for is kept in ``info``."""
        limits = self.cell.limits
        with _no_tf32():
            readings = self.train_readings() if self.train else self.eval_readings()
        self.run.checks = {k: (v, limits[k]) for k, v in readings.items() if k in limits}
        self.run.info = {k: v for k, v in readings.items() if k not in limits}
        return self.run.checks

    def eval_sample(self) -> np.ndarray:
        """The questions the check compares: the ``sample_longest`` longest
        and ``sample`` more drawn from the seed."""
        tr, lengths = self.traffic, self.data["lengths"]
        longest = np.argsort(lengths, kind="stable")[-tr["sample_longest"]:]
        rest = np.setdiff1d(np.arange(len(lengths)), longest)
        rng = np.random.default_rng(derive(self.seed, SAMPLE))
        return np.concatenate([longest, rng.choice(rest, tr["sample"], replace=False)])

    def reference_logits(self, rows: np.ndarray, fp8: bool = False) -> torch.Tensor:
        """The reference's logits of the questions ``rows``, in blocks of
        similar lengths; the weights rebuilt from the seed."""
        cfg, dev = self.cfg, self.device
        weights = make_params(param_spec(cfg, self.traffic["table"]["dim"]), self.seed, dev)
        order = rows[np.argsort(self.data["lengths"][rows], kind="stable")]
        out = torch.empty((len(rows), cfg["num_answers"]), device=dev)
        where = {int(r): i for i, r in enumerate(rows)}
        with torch.no_grad():
            for s in range(0, len(order), REF_BLOCK):
                block = order[s:s + REF_BLOCK]
                T = int(self.data["lengths"][block].max())
                tokens = torch.from_numpy(self.data["questions"][block, :T]).to(dev)
                visual = self.visual_rows(self.data["image_index"][block])
                logits = ref_models.forward(cfg, weights, tokens, visual, fp8=fp8)
                out[torch.tensor([where[int(r)] for r in block], device=dev)] = logits
        return out

    def visual_rows(self, images: np.ndarray) -> torch.Tensor:
        """The table's rows of ``images`` as the reference reads them (the
        table kind's ``rows``)."""
        return self.tables.rows(self.traffic, self.seed, images, self.device, self.table)

    def eval_readings(self) -> Dict[str, float]:
        ans_to_aid = {a: i for i, a in enumerate(self.aid_to_ans)}
        answered = {r["question_id"]: ans_to_aid[r["answer"]] for r in self.results}
        n = len(self.data["lengths"])
        unanswered = n - len(answered) + (len(self.results) - len(answered))
        rows = self.eval_sample()
        got = torch.tensor([answered.get(int(r), 0) for r in rows], device=self.device)
        return {**answer_gaps(self.reference_logits(rows), got), "unanswered": float(unanswered)}

    def train_reference(self, fp8: bool = False) -> dict:
        dev, data = self.device, self.data
        batches = []
        for step, b in enumerate(self.first["batches"]):
            rows = b["question_id"]
            T = int(data["lengths"][rows].max())
            batches.append({
                "step": step, "parts": self.world,
                "tokens": torch.from_numpy(data["questions"][rows, :T]).to(dev),
                "visual": self.visual_rows(data["image_index"][rows]),
                "answer": torch.from_numpy(b["answer"]).to(dev)})
        weights = make_params(param_spec(self.cfg, self.traffic["table"]["dim"]), self.seed, dev)
        return ref_train.train_steps(self.cfg, weights, batches, self.seed, fp8=fp8)

    def labels_outside_pool(self) -> int:
        """Sampled labels that are none of the question's in-vocabulary
        answers (nor its consensus answer where it has none)."""
        bad = 0
        for b in self.first["batches"]:
            rows = b["question_id"]
            pool = self.data["answer_pool"][rows]
            label = b["answer"][:, None]
            in_pool = ((pool == label) & (pool >= 0)).any(axis=1)
            fallback = ~(pool >= 0).any(axis=1) & (b["answer"] == self.data["answers"][rows])
            bad += int((~(in_pool | fallback)).sum())
        return bad

    def train_readings(self) -> Dict[str, float]:
        first, names = self.first, self.first["names"]
        got = {"loss": [float(x) for x in first["loss"]], "grad_norms": first["grad_norms"],
               "params": {k: p.float() for k, p in zip(names, first["params"])}}
        print("checked steps: length buckets " + ", ".join(map(str, first["buckets"])),
              file=sys.stderr)
        return {**self.train_gaps(got, self.train_reference()),
                "labels_outside_pool": float(self.labels_outside_pool())}

    def train_gaps(self, got: dict, ref: dict) -> Dict[str, float]:
        """The gaps of ``got`` (a train run's ``loss`` and ``grad_norms`` per
        step, ``params`` after the checked steps) from the reference's
        ``ref``: the largest relative gap of a step's loss, the worst leaf's
        gap of a step's gradient norm over the checked steps, and the worst
        leaf's gap of the change's norm."""
        weights = make_params(param_spec(self.cfg, self.traffic["table"]["dim"]), self.seed,
                              self.device)
        names = list(ref["grad_norms"][0])
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
        moved = {k: float((got["params"][k] - weights[k]).norm()) for k in names}
        moved_ref = {k: float((ref["params"][k] - weights[k]).norm()) for k in names}
        return {"loss_gap": loss_gap,
                "grad_gap": max(worst_leaf_gap(g, r)
                                for g, r in zip(got["grad_norms"], ref["grad_norms"])),
                "change_gap": worst_leaf_gap(moved, moved_ref, moving(ref["grad_norms"][0]))}


def answer_gaps(ref: torch.Tensor, answers: torch.Tensor) -> Dict[str, float]:
    """The gap by which the reference's logit of each answer given lies
    below its best logit of the question (0 where the answer is its best):
    the widest (``logit_gap``) and the mean over the questions
    (``mean_gap``, which grows with the square of the logits' error, so it
    parts a precision from the one below it where the widest swings too
    much from seed to seed to)."""
    gaps = ref.max(dim=-1).values - ref.gather(1, answers[:, None])[:, 0]
    return {"logit_gap": float(gaps.max()), "mean_gap": float(gaps.mean())}


def moving(ref_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: its
    norm at least ``share`` of the median leaf's."""
    median = statistics.median(ref_norms.values())
    return [k for k, v in ref_norms.items() if v >= share * median]


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Optional[List[str]] = None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    leaves = list(want) if leaves is None else leaves
    median = statistics.median(want[k] for k in leaves)
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in leaves)


@contextlib.contextmanager
def _no_tf32():
    """float32 products in float32: TF32 off for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
