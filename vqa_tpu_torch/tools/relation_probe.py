"""``relation_attend`` on the card, beyond ``chip_smoke.py``'s check:
against an older build of ``vqa_tpu_torch/csrc/relation.cu``, with the
schedule (``ops.relation.relation_plan``) overridden, and with phases cut
out of the source.

    git show 74dfedf:vqa_tpu_torch/csrc/relation.cu > logs/relation_old.cu
    python -m vqa_tpu_torch.tools.relation_probe --old logs/relation_old.cu
    python -m vqa_tpu_torch.tools.relation_probe --cuts [--out logs/relation_cuts]
    python -m vqa_tpu_torch.tools.relation_probe --cuts --old logs/relation_old.cu

``--old SRC`` builds SRC with nvcc next to it (use a git-ignored directory
such as ``logs/``) and calls its entries with the ABI of the parent
(``vqa_relation_attend`` for N <= 64, ``vqa_relation_attend_tiled`` past
it, no schedule arguments). At each shape of ``SHAPES`` it times the old and
the shipped kernel in turns (old, new, new, old; each the median of its two
turns), two ways: ``ms``, the median CUDA-event time of one call, and
``device_ms``, the mean of 20 calls back to back. Both kernels are called
by ctypes with their inputs ready (the shipped one with its plan already
made), so the launch paths match. It reports each one's largest difference
from the fp32 plain version and the largest difference between the two.

Without ``--cuts``, each shape also runs the schedules in ``VARIANTS`` (the
plan with its design or ``split`` forced, where that gives another
schedule that fits), in the order given and then reversed (``device_ms``),
each checked against the fp32 plain version.

``--cuts``: the shipped source with one phase cut out (strings replaced; an
anchor that is not in the source is an error), each variant compiled into
its own library under ``--out`` and timed (``device_ms``) at ``SHAPES`` in
the order given and then reversed. With ``--old SRC`` the cuts are made in
SRC (the parent's anchors, ``PARENT_CUTS``) and called with its ABI. Every
cut that drops a copy completes its mbarrier with no bytes, so nothing
waits forever. The cut variants compute wrong results by design: they say
where the time goes.

Prints one JSON line per shape and writes them to
``chiprun_out/relation_probe.json`` (``relation_cuts.json`` for ``--cuts``).
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
from vqa_tpu_torch.ops.relation import (_DESIGNS, relation_attend_reference, relation_plan)
from vqa_tpu_torch.tools.glimpse_probe import _build_so, _device_ms, _median_ms

HBM = 3.35e12       # bytes/s of an H100 SXM (NVIDIA's data sheet, 700 W)
PEAK_BF16 = 989e12  # FLOP/s on its tensor cores
TOL = 0.01          # each kernel against the fp32 plain version (chip_smoke.py's RELATION_ATOL)
# (B, N, D): CoR at the eval and the serving batch over 36 regions and over
# the extract CLI's 196-region grid; N=48 and 64, either side of the
# element design's limit
SHAPES = ((1024, 36, 1024), (64, 36, 1024), (1024, 196, 1024), (64, 196, 1024),
          (1024, 48, 1024), (1024, 64, 1024))
VARIANTS = {
    "split1": {"design": "element", "split": 1},
    "split2": {"design": "element", "split": 2},
    "split4": {"design": "element", "split": 4},
    "split8": {"design": "element", "split": 8},
    "tiled": {"design": "tiled"},
}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                   "relation.cu")
# the shipped source's cuts: variant -> (anchor, replacement) pairs
CUTS = {
    "shipped": [],
    "empty": [(f"  extern __shared__ __align__(16) unsigned char {name}[];\n",
               f"  extern __shared__ __align__(16) unsigned char {name}[];\n  if (N > 0) return;\n")
              for name in ("smem", "smem_raw")],
    # pg's and r's copies gone; each barrier completed with no bytes
    "no_copy": [("mbar_expect_tx(bar, copy_bytes);", "mbar_expect_tx(bar, 0u);"),
                ("for (int row = lane; row < 2 * N; row += 32) {",
                 "for (int row = lane; row < 0; row += 32) {"),
                ("mbar_expect_tx(full + s, stage_tx);", "mbar_expect_tx(full + s, 0u);"),
                ("if (scores) tma_2d(", "if (N < 0) tma_2d("),
                ("for (int q = 0; q < sh.nbox; ++q) {\n            tma_2d(",
                 "for (int q = 0; q < 0; ++q) {\n            tma_2d(")],
    "no_scores": [("for (int u = warp; u < units; u += kEW) {",
                   "for (int u = warp; u < 0; u += kEW) {"),
                  ("      score_chunk(", "      if (N < 0) score_chunk(")],
    "no_softmax": [("for (int li = warp; li < mine; li += kEW) {  // softmax",
                    "for (int li = warp; li < 0; li += kEW) {  // softmax"),
                   ("for (int i = warp; i < rows; i += kTW) {  // softmax",
                    "for (int i = warp; i < 0; i += kTW) {  // softmax")],
    "no_wsum": [("for (int kt = 0; kt < kMaxKt; ++kt) {  // weighted sum",
                 "for (int kt = 0; kt < 0; ++kt) {  // weighted sum"),
                ("for (int kt = 0; kt < kts; ++kt) {  // weighted sum",
                 "for (int kt = 0; kt < 0; ++kt) {  // weighted sum")],
    "no_store": [("if (store_ok) {", "if (store_ok && D < 0) {"),
                 ("        bulk_store(ob", "        if (N < 0) bulk_store(ob"),
                 ("        tma_store_3d(", "        if (N < 0) tma_store_3d(")],
}
# the parent's (74dfedf) cuts, the element kernel's and the tiled kernel's
PARENT_CUTS = {
    "shipped": [],
    "empty": [("  const int ld = D + kPad;                     // shared row stride of r\n",
               "  if (N > 0) return;\n  const int ld = D + kPad;\n"),
              ("  bf16* pg_s = reinterpret_cast<bf16*>(smem);  // [16, D], zero rows past the "
               "tile\n", "  if (N > 0) return;\n  bf16* pg_s = reinterpret_cast<bf16*>(smem);\n")],
    "no_copy": [("    for (int i = tid; i < N * n_col; i += kThreads) {",
                 "    for (int i = tid; i < 0; i += kThreads) {"),
                ("    for (int i = tid; i < kTileRows * n_col; i += kThreads) {",
                 "    for (int i = tid; i < 0; i += kThreads) {")],
    "no_scores": [("    for (int p = warp; p < n_mt * n_ntg; p += kWarps) {",
                   "    for (int p = warp; p < 0; p += kWarps) {"),
                  ("  for (int j = warp; j < N; j += kWarps) {",
                   "  for (int j = warp; j < 0; j += kWarps) {")],
    "no_softmax": [("  for (int i = warp; i < n_pad; i += kWarps) {",
                    "  for (int i = warp; i < 0; i += kWarps) {"),
                   ("  for (int i = warp; i < kTileRows; i += kWarps) {",
                    "  for (int i = warp; i < 0; i += kWarps) {")],
    "no_wsum": [("#pragma unroll 2\n    for (int j = 0; j < N; ++j) {",
                 "#pragma unroll 2\n    for (int j = 0; j < 0; ++j) {"),
                ("#pragma unroll 4\n    for (int j = 0; j < N; ++j) {",
                 "#pragma unroll 4\n    for (int j = 0; j < 0; ++j) {")],
    "no_store": [("      if (i0 + rr < N) {", "      if (i0 + rr < N && D < 0) {"),
                 ("      if (i < ni) {\n#pragma unroll",
                  "      if (i < ni && D < 0) {\n#pragma unroll")],
}


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _inputs(B, N, D, dev):
    torch.manual_seed(0)  # r = tanh(.) as on the CoR path
    pg = torch.tanh(torch.randn(B, N, D, device=dev)).bfloat16()
    r = torch.tanh(torch.randn(B, N, D, device=dev)).bfloat16()
    return pg, r


def _bound_ms(B, N, D) -> float:
    """pg, r in and out written once; 2 x B N^2 D multiply-adds in bf16."""
    return max(2 * 3 * B * N * D / HBM, 4 * B * N * N * D / PEAK_BF16) * 1e3


def _caller(lib, pg, r, out, stream, plan=None):
    """A ctypes call of ``lib``'s entry: the shipped ABI with ``plan``, or
    the parent's (no plan)."""
    B, N, D = pg.shape
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (pg, r, out)]
    s = ctypes.c_void_p(stream)
    if plan is None:
        fn = lib.vqa_relation_attend if N <= 64 else lib.vqa_relation_attend_tiled
        args = (*ptrs, B, N, D, s)
    else:
        fn = lib.vqa_relation_attend
        args = (*ptrs, B, N, D, _DESIGNS[plan["design"]], plan["split"], plan["stages"], s)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"relation_attend launch error {err}")
    return call


def _plan(B, N, D, **override):
    return relation_plan(B, N, D, smem_limit=_build.smem_optin(0), **override)


def probe(old_src: str | None) -> list:
    dev = torch.device("cuda:0")
    print(_smi(), flush=True)
    lib = _build.library()
    old = _build_so(old_src) if old_src else None
    stream = _build.current_stream(dev)
    records = []
    for B, N, D in SHAPES:
        pg, r = _inputs(B, N, D, dev)
        ref = relation_attend_reference(pg.float(), r.float())
        plan = _plan(B, N, D)
        out = torch.empty_like(pg)
        new = _caller(lib, pg, r, out, stream, plan)
        new()
        torch.cuda.synchronize()
        rec = {"B": B, "N": N, "D": D, "bound_ms": _bound_ms(B, N, D),
               "plan": {k: plan[k] for k in ("design", "split", "stages", "ctas", "smem_bytes")},
               "max_abs_err": (out.float() - ref).abs().max().item()}
        shipped = out.clone()
        if old is not None:
            old_out = torch.empty_like(pg)
            run_old = _caller(old, pg, r, old_out, stream)
            run_old()
            torch.cuda.synchronize()
            rec["old_max_abs_err"] = (old_out.float() - ref).abs().max().item()
            rec["old_max_abs_diff"] = (old_out.float() - shipped.float()).abs().max().item()
            times = {"old": [], "new": [], "old_device": [], "new_device": []}
            iters = 5 if B * N * N > 1024 * 64 * 64 else 20
            for name in ("old", "new", "new", "old"):
                fn = run_old if name == "old" else new
                times[name].append(_median_ms(fn, iters=iters))
                times[name + "_device"].append(_device_ms(fn, reps=iters))
            rec["old_ms"], rec["ms"], rec["old_device_ms"], rec["device_ms"] = (
                statistics.median(times[k]) for k in ("old", "new", "old_device", "new_device"))
            rec["speedup_device"] = rec["old_device_ms"] / rec["device_ms"]
        else:
            rec["ms"], rec["device_ms"] = _median_ms(new), _device_ms(new)
        rec["device_pct_of_bound"] = 100 * rec["bound_ms"] / rec["device_ms"]
        if rec["max_abs_err"] > TOL or rec.get("old_max_abs_err", 0.0) > TOL:
            raise RuntimeError(f"relation_attend off the plain version: {rec}")
        variants = []
        for name, override in VARIANTS.items():
            try:
                vplan = _plan(B, N, D, **override)
            except ValueError:
                continue
            if any(vplan[k] != plan[k] for k in ("design", "split", "stages")):
                variants.append((name, vplan))
        vtimes, verrs = {n: [] for n, _ in variants}, {}
        for name, vplan in variants + variants[::-1]:
            vout = torch.empty_like(pg)
            call = _caller(lib, pg, r, vout, stream, vplan)
            vtimes[name].append(_device_ms(call))
            verrs[name] = (vout.float() - ref).abs().max().item()
            if verrs[name] > TOL:
                raise RuntimeError(f"variant {name} off the plain version by {verrs[name]}")
        rec["variants_device_ms"] = {n: statistics.mean(t) for n, t in vtimes.items()}
        rec["variants_max_abs_err"] = verrs
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del pg, r, ref, out, shipped
    return records


def cuts(out_dir: str, old_src: str | None) -> list:
    dev = torch.device("cuda:0")
    print(_smi(), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(old_src or SRC) as f:
        source = f.read()
    table = PARENT_CUTS if old_src else CUTS
    jobs = {}
    for name, edits in table.items():
        src = source
        for anchor, repl in edits:
            if anchor not in src:
                raise RuntimeError(f"cut {name}: anchor not found: {anchor!r}")
            src = src.replace(anchor, repl)
        path = os.path.join(out_dir, f"relation_{'old_' if old_src else ''}{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.splitext(path)[0] + ".so"  # every variant's nvcc at once
        jobs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", path,
                                            "-o", so], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"cut {name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(os.path.abspath(so))
    stream = _build.current_stream(dev)
    records = []
    for B, N, D in SHAPES:
        pg, r = _inputs(B, N, D, dev)
        out = torch.empty_like(pg)
        plan = None if old_src else _plan(B, N, D)
        calls = {n: _caller(lib, pg, r, out, stream, plan) for n, lib in libs.items()}
        times = {n: [] for n in libs}
        iters = 5 if B * N * N > 1024 * 64 * 64 else 20
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(_device_ms(calls[name], reps=iters))
        rec = {"B": B, "N": N, "D": D, "source": old_src or SRC, "bound_ms": _bound_ms(B, N, D),
               "plan": None if plan is None else {k: plan[k] for k in ("design", "split",
                                                                          "stages")},
               "device_ms": {n: statistics.mean(t) for n, t in times.items()}}
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del pg, r, out
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", help="an older relation.cu to time against (or, with --cuts, "
                                      "to cut)")
    parser.add_argument("--cuts", action="store_true", help="time the cut variants")
    parser.add_argument("--out", default=os.path.join("logs", "relation_cuts"),
                        help="where --cuts writes its sources and libraries")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("relation_probe needs a CUDA card", file=sys.stderr)
        return 1
    records = cuts(args.out, args.old) if args.cuts else probe(args.old)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "relation_cuts.json" if args.cuts else "relation_probe.json"
    if args.cuts and args.old:
        name = "relation_old_cuts.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
