"""Named spans of the port's host work in a ``torch.profiler`` trace.

``with span("vqa_tpu_torch.<layer>.<what>"):`` marks the block as a
``user_annotation`` event of that name in the trace a running profiler
records (the CLI's ``--profile_dir``), on the same clock as the CUDA
runtime calls made inside it and, through their correlation ids, the
kernels those calls launched. The registered ops read ``vqa_tpu_torch::<op>``
in the same trace.

The profiler is the only switch: with none running a span costs one read of
the profiler's flag (``torch.autograd.profiler._is_profiler_enabled``, set
while any profiler runs; on an H100's host it read cheaper than the
thread-local ``torch._C._autograd._profiler_enabled``) and records nothing.
The profiler records the thread that started it, so a span in another
thread (the loader's producer) never reaches its trace: the spans sit on the
main thread, where the CLI's ``--profile_dir`` starts it.

The spans of an eval epoch, in the order they run:

- ``vqa_tpu_torch.loader.take`` (``datasets/pipeline.py``), once a batch:
  the main thread's wait for the producer thread's next batch (or, with no
  producer thread, the batch's assembly and copy to the card);
- ``vqa_tpu_torch.eval.step`` (``engine/engine.py``), once a batch: the
  batch's gather, forward and outputs queued on the card;
- ``vqa_tpu_torch.eval.readback``, once an epoch: the outputs packed, the
  epoch's one copy to the host, which waits for the card to finish the
  epoch (and, across processes, the gather of every rank's outputs);
- ``vqa_tpu_torch.eval.results``, once an epoch: the results rows and the
  totals built on the host.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler runs, else a context
    that does nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
