"""``glimpse_head`` and ``glimpse_attend`` on the card, beyond
``chip_smoke.py``'s check: against an older build of
``vqa_tpu_torch/csrc/glimpse_head.cu``, and with the schedule
(``ops.attention.glimpse_plan``) overridden.

    git show 7f2fb9a:vqa_tpu_torch/csrc/glimpse_head.cu > logs/glimpse_old.cu
    python -m vqa_tpu_torch.tools.glimpse_probe --old logs/glimpse_old.cu
    python -m vqa_tpu_torch.tools.glimpse_probe --cuts [--out logs/glimpse_cuts]

``--old SRC`` builds SRC with nvcc next to it (use a git-ignored directory
such as ``logs/``) and calls its entries with the ABI of the one-block-a-row
design (no schedule arguments). At the archs' shapes it times the old and
the shipped kernel in turns (old, new, new, old; each the median of its two
turns' median CUDA-event times of one call) and checks the old one against
the shipped one (largest absolute difference). Each kernel is timed two
ways: ``ms``, the median CUDA-event time of one call (as ``chip_smoke.py``
times it), and ``device_ms``, the mean of 20 calls back to back (the
device's time, the host's launch gaps hidden where a call outlasts them).
It also times an empty kernel launched the same way: the floor a call of a
few microseconds sits on.

At each shape, the shipped kernel also runs the schedules in
``VARIANTS`` (the plan with its design or ``split`` forced), in
the order given and then reversed (``device_ms`` each), each checked
against the shipped schedule's output (within 0.05: another design sums in another order).

``--cuts``: the ring kernel's source with one phase cut out (strings
replaced; an anchor that is not in the source is an error), each compiled
by nvcc into its own library under ``--out`` and called by ctypes with the
shipped ABI and the ring's schedule, timed (``device_ms``) at the archs'
batch-1024 shapes in the order given and then reversed. The cut variants
compute wrong results by design: they say where the time goes.

Prints one JSON line per shape and writes them to
``chiprun_out/glimpse_probe.json`` (``glimpse_cuts.json`` for ``--cuts``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from vqa_tpu_torch.ops import _build
from vqa_tpu_torch.ops.attention import (_COPY, glimpse_plan, launch_glimpse_attend,
                                         launch_glimpse_head)

HBM = 3.35e12  # bytes/s of an H100 SXM (NVIDIA's data sheet, 700 W)
TOL = 0.05     # two designs' outputs: alpha and the output rounded to bf16 (as chip_smoke.py)
# (entry, B, R, M, G, D): M=510 MutanAtt, M=512 MFB/MFH; glimpse_attend at
# MFB's question self-attention (R = the bucket's T)
SHAPES = (("head", 1024, 36, 510, 2, 2048), ("head", 1024, 36, 512, 2, 2048),
          ("head", 64, 36, 510, 2, 2048), ("attend", 1024, 7, 0, 2, 1024),
          ("attend", 1024, 13, 0, 2, 1024), ("attend", 1024, 26, 0, 2, 1024),
          ("attend", 64, 26, 0, 2, 1024))
# schedule overrides (glimpse_plan's keywords) tried at every shape where
# they give another schedule that fits
VARIANTS = {
    "parent": {"copy": "parent"},  # the one-block-a-row kernel
    "bulk": {"copy": "bulk"},  # the ring, split by the plan's rule
    "bulk_split1": {"copy": "bulk", "split": 1},
    "bulk_split2": {"copy": "bulk", "split": 2},
    "bulk_split4": {"copy": "bulk", "split": 4},
}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                   "glimpse_head.cu")
CUT_SHAPES = (("head", 1024, 36, 510, 2, 2048), ("attend", 1024, 26, 0, 2, 1024),
              ("attend", 1024, 7, 0, 2, 1024))
CUT_PLAN = {"copy": "bulk"}  # the cuts run the ring at every cut shape
CUTS = {  # variant -> (anchor, replacement) pairs on the shipped source (the ring kernel)
    "shipped": [],
    "empty": [("  constexpr bool kBulk = kMode == kModeBulk;\n",
               "  constexpr bool kBulk = kMode == kModeBulk;\n  if (p.B > 0) return;\n")],
    # v's copies gone, each stage's barrier completed with no bytes
    "no_v": [("mbar_expect_tx(full + s, static_cast<unsigned>(nr * dc * 2));",
              "mbar_expect_tx(full + s, 0u);"),
             ("for (int rr = lane; rr < nr; rr += 32) {", "for (int rr = lane; rr < 0; rr += 32) {")],
    "no_logits": [("for (int rr = warp; rr < mine; rr += kWarps) {",
                   "for (int rr = warp; rr < 0; rr += kWarps) {")],
    "no_wsum": [("      if (active) {\n        const bf16* vs",
                 "      if (false) {\n        const bf16* vs")],
}
_HEAD_ONLY = ("no_logits",)
_EMPTY = r"""
__global__ void empty_kernel() {}
extern "C" int vqa_empty(int grid, void* stream) {
  empty_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def _median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 20, trials: int = 9, warmup: int = 3) -> float:
    """Device time of one call: the median over trials of the mean of
    ``reps`` back-to-back calls between two CUDA events (the host's launch
    gaps hide behind the device's queue where a launch outlasts them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _build_so(src: str) -> ctypes.CDLL:
    so = os.path.splitext(src)[0] + ".so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o", so], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(os.path.abspath(so))


def _inputs(kind, B, R, M, G, D, dev):
    torch.manual_seed(0)
    v = torch.randn(B, R, D, device=dev).bfloat16()
    if kind == "head":
        joint = torch.tanh(torch.randn(B, R, M, device=dev)).bfloat16()
        w = (torch.randn(M, G, device=dev) / M ** 0.5).bfloat16()
        b = (0.1 * torch.randn(G, device=dev)).bfloat16()
        return joint, w, b, v
    return torch.randn(B, R, G, device=dev).bfloat16(), v


def _bound_ms(kind, B, R, M, G, D) -> float:
    if kind == "head":  # joint, w, b, v in; attended, logits out
        nbytes = 2 * (B * R * M + M * G + G + B * R * D + B * G * D + B * R * G)
    else:  # logits, v in; attended out
        nbytes = 2 * (B * R * G + B * R * D + B * G * D)
    return nbytes / HBM * 1e3


_KEYS = ("copy", "split", "chunk", "stages", "staged")


def _variant_plan(plan: dict, override: dict, shape: tuple):
    """The plan with ``override``, or None where it is the same schedule or
    does not fit."""
    try:
        vplan = glimpse_plan(*shape, smem_limit=_build.smem_optin(0), **override)
    except ValueError:
        return None
    return None if all(vplan[k] == plan[k] for k in _KEYS) else vplan


def probe(old_src: str | None) -> list:
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    old = _build_so(old_src) if old_src else None
    stream = _build.current_stream(dev)
    records = []
    if old is not None:
        empty_src = os.path.join(os.path.dirname(old_src), "glimpse_probe_empty.cu")
        with open(empty_src, "w") as f:
            f.write(_EMPTY)
        empty = _build_so(empty_src)
        for grid in (512, 2048):
            def launch_empty():
                return empty.vqa_empty(grid, ctypes.c_void_p(stream))
            records.append({"empty_kernel_grid": grid, "ms": _median_ms(launch_empty),
                            "device_ms": _device_ms(launch_empty)})
            print(json.dumps(records[-1]), flush=True)
    for kind, B, R, M, G, D in SHAPES:
        args = _inputs(kind, B, R, M, G, D, dev)
        att = torch.empty(B, G, D, dtype=torch.bfloat16, device=dev)
        logits = torch.empty(B, R, G, dtype=torch.bfloat16, device=dev)
        plan = glimpse_plan(B, R, M, G, D, smem_limit=_build.smem_optin(0))

        def new(p=plan, out=att):
            if kind == "head":
                launch_glimpse_head(*args, out, logits, p)
            else:
                launch_glimpse_attend(*args, out, p)

        rec = {"kernel": f"glimpse_{kind}", "B": B, "R": R, "M": M, "G": G, "D": D,
               "plan": {k: plan[k] for k in (*_KEYS, "ctas", "smem_bytes")},
               "bound_ms": _bound_ms(kind, B, R, M, G, D)}
        new()
        torch.cuda.synchronize()
        shipped = att.clone()
        if old is not None:
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args]
            old_out = torch.empty_like(att)
            if kind == "head":
                def run_old():
                    return old.vqa_glimpse_head(*ptrs, ctypes.c_void_p(old_out.data_ptr()),
                                                ctypes.c_void_p(logits.data_ptr()), B, R, M, G,
                                                D, ctypes.c_void_p(stream))
            else:
                def run_old():
                    return old.vqa_glimpse_attend(*ptrs, ctypes.c_void_p(old_out.data_ptr()), B,
                                                  R, G, D, ctypes.c_void_p(stream))
            if run_old() != 0:
                raise RuntimeError(f"the old build refused {rec}")
            torch.cuda.synchronize()
            rec["old_max_abs_diff"] = (old_out.float() - shipped.float()).abs().max().item()
            times = {"old": [], "new": [], "old_device": [], "new_device": []}
            for name in ("old", "new", "new", "old"):
                fn = run_old if name == "old" else new
                times[name].append(_median_ms(fn))
                times[name + "_device"].append(_device_ms(fn))
            rec["old_ms"], rec["ms"], rec["old_device_ms"], rec["device_ms"] = (
                statistics.median(times[k]) for k in ("old", "new", "old_device", "new_device"))
        else:
            rec["ms"], rec["device_ms"] = _median_ms(new), _device_ms(new)
        rec["pct_of_bound"] = 100 * rec["bound_ms"] / rec["ms"]
        rec["device_pct_of_bound"] = 100 * rec["bound_ms"] / rec["device_ms"]
        variants = [(n, vp) for n, vp in ((n, _variant_plan(plan, o, (B, R, M, G, D)))
                                          for n, o in VARIANTS.items()) if vp is not None]
        times = {n: [] for n, _ in variants}
        diffs = {}
        for name, vplan in variants + variants[::-1]:
            out = torch.empty_like(att)
            times[name].append(_device_ms(lambda: new(vplan, out)))
            torch.cuda.synchronize()
            # another design sums in another order: within bf16 rounding
            diffs[name] = (out.float() - shipped.float()).abs().max().item()
            if diffs[name] > TOL:
                raise RuntimeError(f"variant {name} differs from the shipped schedule by "
                                   f"{diffs[name]} at {rec}")
        rec["variants_max_abs_diff"] = diffs
        rec["variants_device_ms"] = {n: statistics.mean(t) for n, t in times.items()}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def cuts(out_dir: str) -> list:
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.library()
    os.makedirs(out_dir, exist_ok=True)
    with open(SRC) as f:
        shipped = f.read()
    libs = {}
    for name, edits in CUTS.items():
        src = shipped
        for anchor, repl in edits:
            if anchor not in src:
                raise RuntimeError(f"cut {name}: anchor not found: {anchor!r}")
            src = src.replace(anchor, repl)
        path = os.path.join(out_dir, f"glimpse_{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        libs[name] = _build_so(path)
    stream = ctypes.c_void_p(_build.current_stream(dev))
    records = []
    for kind, B, R, M, G, D in CUT_SHAPES:
        args = [ctypes.c_void_p(t.data_ptr()) for t in _inputs(kind, B, R, M, G, D, dev)]
        att = torch.empty(B, G, D, dtype=torch.bfloat16, device=dev)
        logits = torch.empty(B, R, G, dtype=torch.bfloat16, device=dev)
        out = ctypes.c_void_p(att.data_ptr())

        def run(lib, plan):
            sched = (plan["split"], plan["chunk"], plan["stages"])
            if kind == "head":
                err = lib.vqa_glimpse_head(*args, out, ctypes.c_void_p(logits.data_ptr()), B, R, M,
                                           G, D, *sched, int(plan["staged"]), _COPY[plan["copy"]],
                                           stream)
            else:
                err = lib.vqa_glimpse_attend(*args, out, B, R, G, D, *sched, _COPY[plan["copy"]],
                                             stream)
            if err:
                raise RuntimeError(f"launch error {err}")

        names = [n for n in CUTS if kind == "head" or n not in _HEAD_ONLY]
        plans = {n: glimpse_plan(B, R, M, G, D, smem_limit=_build.smem_optin(0), **CUT_PLAN)
                 for n in names}
        times = {n: [] for n in names}
        for name in names + names[::-1]:
            times[name].append(_device_ms(lambda: run(libs[name], plans[name])))
        rec = {"kernel": f"glimpse_{kind}", "B": B, "R": R, "M": M, "G": G, "D": D,
               "bound_ms": _bound_ms(kind, B, R, M, G, D),
               "device_ms": {n: statistics.mean(t) for n, t in times.items()}}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", help="an older glimpse_head.cu to time against")
    parser.add_argument("--cuts", action="store_true", help="time the cut variants")
    parser.add_argument("--out", default=os.path.join("logs", "glimpse_cuts"),
                        help="where --cuts writes its sources and libraries")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("glimpse_probe needs a CUDA card", file=sys.stderr)
        return 1
    records = cuts(args.out) if args.cuts else probe(args.old)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "glimpse_cuts.json" if args.cuts else "glimpse_probe.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
