"""Batching pipeline, a copy of ``vqa_tpu/datasets/pipeline.py`` (the port
imports nothing of the JAX package).

Deterministic epoch iteration over a VQA2Dataset with background batch
assembly: a host thread assembles each batch (numpy fancy-indexing over
RAM-resident arrays) and maps it through ``transform`` (the eval loop's copy
to the card, ``engine.engine.make_device_transform``), so assembly and
transfer overlap the card's work on the previous batch.

Determinism contract: epoch order is a pure function of (seed, epoch), so
resume-at-epoch reproduces the exact stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from vqa_tpu_torch.datasets.vqa2 import VQA2Dataset
from vqa_tpu_torch.utils.spans import span


def normalize_buckets(buckets, maxlength: int) -> tuple:
    """Validate a question-length bucket ladder: strictly increasing
    positive ints; entries >= maxlength are redundant and dropped; maxlength
    is appended so every batch has a covering bucket."""
    out = tuple(int(b) for b in buckets)
    if any(b <= 0 for b in out):
        raise ValueError(f"length buckets must be positive, got {out}")
    if list(out) != sorted(set(out)):
        raise ValueError(f"length buckets must be strictly increasing, got {out}")
    out = tuple(b for b in out if b < maxlength)
    return out + (maxlength,)


def epoch_order(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n).astype(np.int64)


class BatchIterator:
    """Iterates dict-of-numpy batches; optionally maps them through
    ``transform`` (e.g. a copy to the card) on the background thread
    so transfer overlaps compute.
    """

    def __init__(
        self,
        dataset: VQA2Dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        pad_last: bool = False,
        transform: Optional[Callable[[Dict[str, np.ndarray]], object]] = None,
        prefetch: int = 2,
        sort_by_length: bool = False,
        length_buckets: Optional[tuple] = None,
        bucket_window: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        shard_even: bool = False,
    ):
        """``sort_by_length`` + ``length_buckets`` implement eval-time length
        bucketing: batches are drawn in question-length order and the padded
        question axis is truncated to the smallest bucket covering the batch,
        so the LSTM scans ~mean-length steps instead of always maxlength.
        Static shapes per bucket -> at most len(length_buckets) compiles.
        Order changes are invisible downstream (results key on question_id);
        not for training (would bias batch composition).

        ``bucket_window`` (train path) implements BUCKETED SHUFFLING: shuffle
        the epoch, sort by length inside windows of bucket_window*batch_size
        examples, then shuffle the batch order. Batches stay random across
        the dataset but length-homogeneous inside, so with ``length_buckets``
        the LSTM scans ~mean length during training too. 0 = off (the
        reference's exact uniform shuffle). Deterministic per (seed, epoch).

        ``shard_index``/``shard_count`` implement per-host input sharding for
        multi-host data parallelism (SURVEY.md section 5.8): each host draws
        the same deterministic epoch order and takes a disjoint strided
        slice, so shards stay balanced under shuffling. ``shard_even``
        truncates every shard to floor(N / shard_count) examples so ALL
        hosts run the SAME number of steps — required in SPMD multi-process
        training, where one host running an extra step deadlocks the
        collectives (parallel/distributed.py)."""
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last are mutually exclusive")
        if sort_by_length and shuffle:
            raise ValueError("sort_by_length is an eval-path feature; disable shuffle")
        if bucket_window and not shuffle:
            raise ValueError("bucket_window is a train-path feature; enable shuffle")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.transform = transform
        self.prefetch = prefetch
        self.sort_by_length = sort_by_length
        self.length_buckets = tuple(length_buckets) if length_buckets else None
        self.bucket_window = bucket_window
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"shard_index {shard_index} out of range for {shard_count}")
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.shard_even = shard_even

    def _shard_len(self) -> int:
        n = len(self.dataset)
        if self.shard_even:
            return n // self.shard_count
        return (n - self.shard_index + self.shard_count - 1) // self.shard_count

    def steps_per_epoch(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _truncate(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.length_buckets is None:
            return batch
        if getattr(self.dataset.opt, "pad", "right") != "right":
            return batch  # left padding puts real tokens at the end
        tmax = int(batch["length"].max())
        bucket = next((b for b in self.length_buckets if b >= tmax), None)
        if bucket is not None and bucket < batch["question"].shape[1]:
            batch["question"] = batch["question"][:, :bucket]
        return batch

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = epoch_order(n, self.seed, epoch, self.shuffle)
        if self.shard_count > 1:
            order = order[self.shard_index :: self.shard_count]
            if self.shard_even:
                order = order[: len(self.dataset) // self.shard_count]
            n = len(order)
        if self.sort_by_length:
            order = order[np.argsort(self.dataset.split.lengths[order], kind="stable")]
        bs = self.batch_size
        starts = np.arange(0, n, bs)
        if self.bucket_window:
            # bucketed shuffle: length-sort inside windows, shuffle batch order
            if self.drop_last and n % bs:
                # drop a UNIFORM-random tail (order is shuffled) BEFORE the
                # window sort — sorting first would drop the final window's
                # longest questions every epoch (persistent training bias)
                n -= n % bs
                order = order[:n]
                starts = np.arange(0, n, bs)
            w = self.bucket_window * bs
            lengths = self.dataset.split.lengths
            order = np.concatenate([
                order[s : s + w][np.argsort(lengths[order[s : s + w]], kind="stable")]
                for s in range(0, n, w)
            ])
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 2]))
            full = starts[starts + bs <= n]
            rng.shuffle(full)
            # any partial batch stays LAST (drop_last/pad_last assume it)
            starts = np.concatenate([full, starts[starts + bs > n]])
        label_rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 1]))
        for start in starts:
            idx = order[start : start + bs]
            if len(idx) < bs:
                if self.drop_last:
                    return
                if self.pad_last:
                    # pad by cyclic tiling (handles bs > dataset size too);
                    # callers mask with 'valid'
                    pad = np.resize(order, bs - len(idx))
                    batch = self.dataset.batch(np.concatenate([idx, pad]), rng=label_rng)
                    valid = np.zeros(bs, dtype=bool)
                    valid[: len(idx)] = True
                    batch["valid"] = valid
                    yield self._truncate(batch)
                    return
            batch = self.dataset.batch(idx, rng=label_rng)
            if self.pad_last:
                batch["valid"] = np.ones(len(idx), dtype=bool)
            yield self._truncate(batch)

    def epoch(self, epoch: int = 0) -> Iterator:
        """Iterate one epoch, with background assembly/transfer. Each batch's
        take on the consuming thread is the span ``vqa_tpu_torch.loader.take``
        (``utils/spans.py``), closed before the batch is handed out; the take
        that finds the epoch's end is no batch's and has none."""
        takes = self.steps_per_epoch()

        def take(get):
            nonlocal takes
            takes -= 1
            if takes < 0:
                return get()
            with span("vqa_tpu_torch.loader.take"):
                return get()

        if self.prefetch <= 0:
            batches = self._batches(epoch)

            def assemble():
                batch = next(batches, None)
                return self.transform(batch) if batch is not None and self.transform else batch

            while (item := take(assemble)) is not None:
                yield item
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def producer():
            try:
                for batch in self._batches(epoch):
                    item = self.transform(batch) if self.transform else batch
                    while not stop.is_set():  # bounded put that honors abandonment
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surface worker errors to the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while (item := take(q.get)) is not sentinel:
                yield item
        finally:
            # consumer may abandon the generator early (break/exception):
            # unblock and drain the producer so threads/buffers don't pin
            stop.set()
            while True:
                try:
                    if q.get_nowait() is sentinel:
                        break
                except queue.Empty:
                    if not t.is_alive():
                        break
            t.join()
        if err:
            raise err[0]
