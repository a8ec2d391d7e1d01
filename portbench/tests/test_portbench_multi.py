"""A cell over several cards, rehearsed on the CPU: four processes over
gloo, started as the benchmark starts them (``run.other_ranks``), the table
row-sharded over them, the train step's one all-reduce, the traced
stretches. Rank 0's check comes out correct, and false with the exchange
between the ranks left out."""

import json
import os
import time

import pytest

from conftest import SEED, tiny_traffic, write_tiny

WORLD = 4


def _measure(base, bench, broken, rank, port):
    import torch

    torch.set_num_threads(1)
    from portbench.calibrate import planted
    from portbench.harness import Harness
    from portbench.spec import load_cell
    from vqa_tpu_torch.parallel import distributed, mesh as mesh_lib

    distributed.initialize(f"localhost:{port}", WORLD, rank, device="cpu")
    h = Harness(load_cell("tiny_mutan_att.sharded", bench, base=base), SEED, "cpu",
                time.time(), mesh_lib.make_mesh(1))
    # broken: the grads' exchange left out, each rank keeps its own
    with planted("no_exchange" if broken else None):
        h.setup()
        h.window(0.5)
        h.traced()
    distributed.barrier()
    distributed.shutdown()
    return h


def _rank(args, rank, port):
    _measure(*args, rank, port)


def _run(tmp_path, broken):
    from portbench.run import other_ranks

    base = str(tmp_path)
    bench = write_tiny(base)
    with open(os.path.join(base, "traffic", "tiny.sharded.json"), "w") as f:
        json.dump(tiny_traffic("train.grid196_sharded"), f)
    bench["workloads"].append({"name": "tiny_mutan_att.sharded", "config": "tiny_mutan_att",
                               "traffic": "tiny.sharded", "chips": WORLD, "why": "tiny"})
    with open(os.path.join(base, "limits", "tiny_mutan_att.train.json")) as f, \
            open(os.path.join(base, "limits", "tiny_mutan_att.sharded.json"), "w") as g:
        g.write(f.read())
    with other_ranks(_rank, (base, bench, broken), WORLD) as (port, ranks):
        h = _measure(base, bench, broken, 0, port)
    assert [p.exitcode for p in ranks] == [0] * (WORLD - 1)
    assert h.run.trace is not None and h.run.device_trace is not None
    h.free_program()
    return h.check()


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "no_exchange"])
def test_four_ranks_over_gloo(tmp_path, broken):
    checks = _run(tmp_path, broken)
    correct = all(v <= lim for v, lim in checks.values())
    assert correct != broken, checks
