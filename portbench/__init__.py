"""The benchmark of ``vqa_tpu_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json`` and
``metrics/<metric>.py``; and so is what those files name (``plugins``): a
model architecture or question encoder of the plain reference
(``reference/archs/``, ``reference/encoders/``), a kind of length
distribution (``lengths/``) or of feature table (``tables/``). The yardstick (traffic generation, weights made
from the seed, FLOP and byte counts, peaks, the reduction of the profiler's
trace, the plain reference and the comparison that decides ``correct``)
lives here; from the program it takes only the system under test.
"""
