"""Layer: loader (``datasets/pipeline.py``). The program's own span
``vqa_tpu_torch.loader.take`` in the traced epoch, the main thread's wait
for each batch from the loader's producer thread: the mean over the
epoch's batches, in ms. A program without the span reads nothing."""

import statistics


def read(run):
    spans = ([float(e["dur"]) for e in run.trace.host if e["name"] == "vqa_tpu_torch.loader.take"]
             if run.trace else [])
    return statistics.fmean(spans) / 1e3 if spans else None
