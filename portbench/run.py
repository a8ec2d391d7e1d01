"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (with ``busy_s``, ``window_s``
and the breakdown). The last line of standard output is the result, one
JSON object; the last lines of standard error are the numbers that decide
``correct``, each beside its limit. Without a CUDA card (or with fewer cards
than the cell asks for), or if the window leaves JAX or the JAX package
loaded, it exits with 2 and prints no result.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every cache the run's libraries keep lives at a fixed path in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "portbench", ".cache", sub)
os.environ["USE_FLAX"] = "0"
# the ranks of a cell over several cards talk over NVLink and TCP, never
# through shared memory files
os.environ["NCCL_SHM_DISABLE"] = "1"

# top-level module names the run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "grain", "vqa_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def result(h, trace: bool) -> dict:
    """The result line of a finished run of ``h`` (a ``harness.Harness``)."""
    import torch

    run, cell = h.run, h.cell
    e2e = {"setup_s": run.setup_s}
    rate = run.questions / run.seconds
    e2e["train_qa_per_s" if h.train else "eval_qa_per_s"] = rate
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = m.read(run)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {m.name: {"value": e2e[m.name], "unit": m.unit} for m in cell.end_to_end}
    device = {"platform": "gpu" if h.device.type == "cuda" else h.device.type,
              "kind": (torch.cuda.get_device_name(h.device) if h.device.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": run.memory_peak}
    out = {"correct": all(v <= lim for v, lim in run.checks.values()),
           "attempted": run.questions, "failed": 0, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.device_trace.busy_us() / 1e6
        device["window_s"] = run.device_trace.window_us() / 1e6
        out["breakdown"] = {"device_ops": run.device_trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def other_ranks(target, argv, chips: int):
    """Ranks 1 to ``chips - 1`` of a cell over several cards, each a spawned
    process running ``target(argv, rank, port)``; yields (port, processes),
    rank 0's store on ``localhost:port`` being the caller's. Leaving waits
    for them; a rank left behind by a failure is stopped."""
    import multiprocessing

    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=target, args=(argv, r, port)) for r in range(1, chips)]
    for p in ranks:
        p.start()
    try:
        yield port, ranks
        for p in ranks:
            p.join(timeout=120)
    finally:
        for p in ranks:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)


def measure(args, cell, rank: int = 0, port: int = 0, device="cuda:0", process_start=None):
    """One rank's set-up, window and traced stretches (``traced`` with
    ``--trace 1``); over several cards the process group joined first, on
    ``localhost:port``, ``device`` this rank's card."""
    from portbench.harness import Harness

    mesh = None
    if cell.chips > 1:
        from vqa_tpu_torch.parallel import distributed
        from vqa_tpu_torch.parallel.mesh import make_mesh

        distributed.initialize(f"localhost:{port}", cell.chips, rank, device=device)
        mesh = make_mesh(1)
    h = Harness(cell, args.seed, device, process_start or time.time(), mesh)
    h.setup()
    h.window(args.seconds)
    if args.trace:
        h.traced()
    return h


def rank_main(argv, rank: int, port: int) -> None:
    """A rank past the first of a cell over several cards: it measures in
    step with rank 0, which reports, then leaves."""
    sys.stdout = sys.stderr   # the result line is rank 0's alone
    from portbench.spec import load_cell
    from vqa_tpu_torch.parallel import distributed

    args = parse(argv)
    h = measure(args, load_cell(args.workload), rank, port, f"cuda:{rank}")
    distributed.barrier()
    h.free_program()
    distributed.shutdown()


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}; "
              "no fallback to the CPU", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed}: {_power()}", file=sys.stderr, flush=True)
    if cell.chips == 1:
        return report(args, measure(args, cell, process_start=PROCESS_START))
    from vqa_tpu_torch.parallel import distributed

    with other_ranks(rank_main, argv or sys.argv[1:], cell.chips) as (port, ranks):
        h = measure(args, cell, 0, port, "cuda:0", PROCESS_START)
        distributed.barrier()
        distributed.shutdown()
    failed = [p.exitcode for p in ranks if p.exitcode != 0]
    if failed:
        print(f"portbench: ranks exited with {failed}", file=sys.stderr)
        return 2
    return report(args, h)


def report(args, h) -> int:
    """Rank 0's check and result, after the JAX check."""
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 2
    h.free_program()
    h.check()
    line = result(h, bool(args.trace))
    for name, value in h.run.info.items():
        print(f"reading {name} {value!r} (no limit: it separates no fault)", file=sys.stderr)
    for name, (value, limit) in h.run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
