"""The readings that the limits of a cell's check are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control] [--fault <fault>]

For each seed, in one process a card: the cell's set-up and one eval epoch
(an eval cell) or its checked train steps, then the numbers the check
compares, as the benchmark's runs read them (``side: program``). With
``--control`` the plain reference computed in float8 takes the program's
place on the same inputs (``side: control``): its answers, or its train
steps, are judged by the same comparison. With ``--fault`` the program
runs with a fault planted under the timed path (``side: <fault>``):
``half_batch`` leaves half of each train batch out of the loss, the mean
taken over the rest; ``no_exchange`` leaves out the train step's exchange
of gradients between the cards. One JSON line per seed and side. The
benchmark's own runs never run this.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["NCCL_SHM_DISABLE"] = "1"

FAULTS = ("half_batch", "no_exchange")


def half_batch_criterion(criterion):
    """The loss over the first half of the batch's rows alone."""

    def half(logits, labels):
        n = logits.shape[0] // 2
        return criterion(logits[:n], labels[:n])

    return half


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted under the timed path."""
    from vqa_tpu_torch.engine import optim
    from vqa_tpu_torch.parallel.mesh import Mesh

    saved = optim.criterion_factory, Mesh.all_reduce_mean
    if fault == "half_batch":
        optim.criterion_factory = lambda *a: half_batch_criterion(saved[0](*a))
    elif fault == "no_exchange":
        Mesh.all_reduce_mean = lambda self, flat: flat
    try:
        yield
    finally:
        optim.criterion_factory, Mesh.all_reduce_mean = saved


def control_readings(h) -> dict:
    """The check's numbers with the float8 reference in the program's place."""
    from portbench.harness import _no_tf32, answer_gaps

    with _no_tf32():
        if not h.train:
            rows = h.eval_sample()
            ref = h.reference_logits(rows)
            return answer_gaps(ref, h.reference_logits(rows, fp8=True).argmax(dim=-1))
        ref, ctl = h.train_reference(), h.train_reference(fp8=True)
        return h.train_gaps(ctl, ref)


def calibrate(cell, seed: int, device, control: bool, fault, mesh=None) -> list:
    """The readings of one seed (rank 0's; none on the other ranks)."""
    from portbench.harness import Harness

    h = Harness(cell, seed, device, time.time(), mesh)
    with planted(fault):
        h.setup()
        if not h.train:
            h.window(0.0)
    h.free_program()
    if not h.primary:
        return []
    h.check()
    lines = [{"seed": seed, "side": fault or "program",
              "readings": {**{k: v for k, (v, _) in h.run.checks.items()}, **h.run.info}}]
    if control:
        lines.append({"seed": seed, "side": "control", "readings": control_readings(h)})
    return lines


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=FAULTS, default=None)
    return p.parse_args(argv)


def seeds_on(argv, rank: int = 0, port: int = 0) -> None:
    """Every seed on this rank's card; rank 0 prints the readings."""
    import torch

    from portbench.spec import load_cell

    args = parse(argv)
    cell = load_cell(args.workload)
    mesh = None
    if cell.chips > 1:
        from vqa_tpu_torch.parallel import distributed
        from vqa_tpu_torch.parallel.mesh import make_mesh

        distributed.initialize(f"localhost:{port}", cell.chips, rank, device=f"cuda:{rank}")
        mesh = make_mesh(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in calibrate(cell, seed, f"cuda:{rank}", args.control, args.fault, mesh):
            print(json.dumps({"workload": args.workload, **line}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if mesh is not None:
            distributed.barrier()
    if mesh is not None:
        distributed.shutdown()


def _rank(argv, rank: int, port: int) -> None:
    sys.stdout = sys.stderr
    seeds_on(argv, rank, port)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = parse(argv)
    import torch

    from portbench.spec import load_cell

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    if chips == 1:
        seeds_on(argv)
        return 0
    from portbench.run import other_ranks

    with other_ranks(_rank, argv, chips) as (port, ranks):
        seeds_on(argv, 0, port)
    return 0 if all(p.exitcode == 0 for p in ranks) else 2


if __name__ == "__main__":
    sys.exit(main())
