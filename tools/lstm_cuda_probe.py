"""``lstm_seq``'s hand-written kernel on the card, beyond ``chip_smoke.py``'s
check: against an older build of ``vqa_tpu_torch/csrc/lstm.cu``, and against
variants of the shipped source with one design choice undone or one phase
cut out.

    git show af8a240:vqa_tpu_torch/csrc/lstm.cu > logs/lstm_old.cu
    python -m tools.lstm_cuda_probe --old logs/lstm_old.cu
    python -m tools.lstm_cuda_probe --variants [--out logs/lstm_variants]

``--old SRC``: builds SRC with nvcc next to it (use a git-ignored directory
such as ``logs/``) and calls its ``vqa_lstm_seq`` with the ABI of the first,
one-launch-a-step design (xg, mask, wh, h_last, seq, h_tmp, c, T, B, H,
stream). At the archs' six shapes it times the two in turns (old, new, new,
old; each time the median of its two turns' median CUDA-event times) beside
the bound (the larger of the bytes over 3.35 TB/s and the T-1 products over
989 TFLOP/s, H100 SXM data sheet), the plain version, and (T-1) x
``torch.addmm(xg_t, h, wh)``: cuBLAS on the products alone, a yardstick,
not the same function.

``--variants``: each variant is the shipped source with strings replaced,
compiled by nvcc into its own library under ``--out`` and called by ctypes
with the shipped ABI. An anchor that is not in the source is an error, so a
variant never silently equals the shipped build (after an edit of
``lstm.cu`` the anchors are rewritten with it):

- ``approx``: the gate nonlinearities on the SFU (``tanh.approx.f32``,
  sigmoid(x) = (1 + tanh(x/2)) / 2, relative error ~2^-11) instead of fp32;
  ``ieee``: the sigmoid's reciprocal by an IEEE division, not ``__fdividef``;
- ``cluster1`` / ``cluster4``: the 128-row class without CTA pairs (every
  CTA loads its own wh) / in clusters of four (each CTA multicasts one gate
  strip);
- ``notail``: the tiles left after the full rounds are not shared over K;
- ``noepi``: no epilogue (no loads, gate math or stores); ``noxg``: the
  epilogue without its xg loads; ``nostore``: without its stores;
  ``nomath``: the gate nonlinearities replaced by products;
- ``nomma``: no wgmma; ``nowh``: no wh loads (the stages carry h alone).

At each shape the variants run in the order given, then reversed; each time
is the mean of its two median CUDA-event times. The cut variants compute
wrong results by design; the others are checked against the plain version,
for bit-equality of two calls, and against the shipped build (the share of
``seq``'s bf16 values equal to it, the mean and the largest absolute
difference).

Both modes check the shipped kernel against the plain version in float32 on
the same bf16 inputs (0.0092, as ``chip_smoke.py``) and for bit-equality of
two calls, print one JSON line per shape, and write them all to
``chiprun_out/lstm_cuda_probe_{old,variants}.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from vqa_tpu_torch.ops import _build
from vqa_tpu_torch.ops.lstm import (gate_strips, launch_geometry, lstm_plan, lstm_seq,
                                    lstm_seq_reference)

PEAK_BF16 = 989e12  # dense bf16 FLOP/s of an H100 SXM (NVIDIA's data sheet, 700 W)
HBM = 3.35e12       # bytes/s
TOL = 0.0092        # twice the worst error over chip_smoke.py's shapes (as its LSTM_ATOL)
OLD_SHAPES = ((26, 1024, 2400), (13, 1024, 2400), (7, 1024, 2400), (26, 64, 2400),
              (7, 1024, 1024), (26, 64, 1024))
VARIANT_SHAPES = ((26, 1024, 2400), (7, 1024, 2400), (7, 1024, 1024), (26, 64, 2400))
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "vqa_tpu_torch",
                   "csrc", "lstm.cu")
_SIGMOID = ("__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + "
            "expf(-x)); }")
_HALF_LOOP = "for (int half = 0; half < 2; ++half) {\n        const int row0"
VARIANTS = {
    "shipped": [],
    "approx": [(_SIGMOID, "__device__ __forceinline__ float tanh_fast(float x) {\n  float y;\n"
                "  asm(\"tanh.approx.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));\n  return y;\n}\n"
                "__device__ __forceinline__ float sigmoid(float x) { return fmaf(0.5f, "
                "tanh_fast(0.5f * x), 0.5f); }"),
               ("* tanhf(", "* tanh_fast(")],
    "ieee": [(_SIGMOID, _SIGMOID.replace("__fdividef(1.f, 1.f + expf(-x))",
                                         "1.f / (1.f + expf(-x))"))],
    "cluster1": [("run<2, 4, 2>", "run<2, 4, 1>")],
    "cluster4": [("run<2, 4, 2>", "run<2, 4, 4>")],
    "notail": [("if (rounds > 0 && rem > 0) {", "if (rounds > 0 && rem > 0 && a.T < 0) {")],
    "noepi": [(_HALF_LOOP, _HALF_LOOP.replace("half < 2", "half < 2 * (a.T < 0)"))],
    "noxg": [("load_rows(xr[g], xg_t", "if (a.T < 0) load_rows(xr[g], xg_t")],
    "nostore": [("        if (last) {\n          slot_to_rows(", "        if (a.T < 0) {\n"
                 "        } else if (last) {\n          slot_to_rows("),
                ("        slot_to_rows(slots + kSlot, a.c", "        if (a.T < 0) slot_to_rows(slots + "
                 "kSlot, a.c"),
                ("        slot_to_rows(slots + 2 * kSlot, a.seq", "        if (a.T < 0) slot_to_rows("
                 "slots + 2 * kSlot, a.seq")],
    "nomath": [("const float new_c = sigmoid(gate[1][e]) * co + sigmoid(gate[0][e]) * "
                "tanhf(gate[2][e]);", "const float new_c = gate[1][e] * co + gate[0][e] * "
                "gate[2][e];"),
               ("const float new_h = sigmoid(gate[3][e]) * tanhf(new_c);",
                "const float new_h = gate[3][e] * new_c;")],
    "nomma": [("wgmma_256(d, smem_desc(", "if (a.T < 0) wgmma_256(d, smem_desc(")],
    "nowh": [("          tma_2d_multicast(dst", "          if (a.T < 0) tma_2d_multicast(dst"),
             ("          tma_2d(dst", "          if (a.T < 0) tma_2d(dst"),
             ("mbar_expect_tx(&full[stage], P::kStageBytes);\n          load_b(stage, u0, kt",
              "mbar_expect_tx(&full[stage], P::kABytes);\n          load_b(stage, u0, kt"),
             ("mbar_expect_tx(&full[stage], P::kStageBytes);\n            load_b(",
              "mbar_expect_tx(&full[stage], P::kABytes);\n            load_b(")],
}
CUT = ("noepi", "noxg", "nostore", "nomath", "nomma", "nowh")
_P, _I = ctypes.c_void_p, ctypes.c_int


def bound_ms(T: int, B: int, H: int) -> tuple:
    """(ms, 'bytes' | 'operations'): each input read once and each output
    written once, against (T-1) products h[B,H] x wh[H,4H] (step 0 has none)."""
    nbytes = 2 * (T * B * 4 * H + T * B + 4 * H * H + B * H + T * B * H)
    flops = 2.0 * (T - 1) * B * H * 4 * H
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / PEAK_BF16 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def inputs(T, B, H, seed=0):
    """bf16 inputs on the card; a quarter of the rows left-padded, lengths 1
    and T among them (as chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    xg = torch.randn(T, B, 4 * H, device=dev, generator=g).to(torch.bfloat16)
    wh = (torch.randn(H, 4 * H, device=dev, generator=g) / H ** 0.5).to(torch.bfloat16)
    lengths = rng.integers(1, T + 1, B)
    lengths[:3] = (1, T, T // 2 + 1)
    left = rng.random(B) < 0.25
    t = np.arange(T)[:, None]
    valid = np.where(left[None, :], t >= T - lengths[None, :], t < lengths[None, :])
    mask = torch.from_numpy(valid[..., None].astype(np.float32)).to(dev, torch.bfloat16)
    return xg, mask, wh


def median_ms(fn, iters=10, warmup=2):
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


def _compile(src: str, out: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(proc: subprocess.Popen, name: str, out: str, argtypes) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
    lib = ctypes.CDLL(os.path.abspath(out))
    lib.vqa_lstm_seq.argtypes, lib.vqa_lstm_seq.restype = argtypes, _I
    return lib


def old_call(lib, xg, mask, wh):
    T, B, _ = xg.shape
    H = wh.shape[0]
    dt, dev = torch.bfloat16, xg.device
    h_last, seq = torch.empty(B, H, dtype=dt, device=dev), torch.empty(T, B, H, dtype=dt,
                                                                      device=dev)
    h_tmp, c = torch.empty(B, H, dtype=dt, device=dev), torch.empty(B, H, dtype=dt, device=dev)
    _build.check(lib.vqa_lstm_seq(xg.data_ptr(), mask.data_ptr(), wh.data_ptr(), h_last.data_ptr(),
                                  seq.data_ptr(), h_tmp.data_ptr(), c.data_ptr(), T, B, H,
                                  _build.current_stream(dev)), "old lstm_seq")
    return h_last, seq


def variant_call(lib, xg, mask, wh):
    """The shipped wrapper's work, through a variant's library."""
    T, B, _ = xg.shape
    H = wh.shape[0]
    plan = lstm_plan(B, H)
    wh, gs = gate_strips(wh)
    dt, dev = torch.bfloat16, xg.device
    h_last, seq = torch.empty(B, H, dtype=dt, device=dev), torch.empty(T, B, H, dtype=dt,
                                                                      device=dev)
    hbuf = torch.empty(2, B, plan["hp"], dtype=dt, device=dev)
    c = torch.empty(B, plan["hp"], dtype=dt, device=dev)
    count = torch.empty(1 + plan["tiles"], dtype=torch.int32, device=dev)  # above any variant's
    part = torch.empty(32 << 20, dtype=torch.uint8, device=dev)            # tail and split
    _build.check(lib.vqa_lstm_seq(xg.data_ptr(), mask.data_ptr(), wh.data_ptr(), h_last.data_ptr(),
                                  seq.data_ptr(), hbuf.data_ptr(), c.data_ptr(), count.data_ptr(),
                                  part.data_ptr(), part.numel(), T, B, H, gs, plan["wg"],
                                  _build.current_stream(dev)), "lstm_seq variant")
    return h_last, seq


def err_of(out, ref):
    return max((out[0].float() - ref[0]).abs().max().item(),
               (out[1].float() - ref[1]).abs().max().item())


def _equal(a, b) -> bool:
    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def _shipped_check(T, B, H, xg, mask, wh) -> dict:
    ref = lstm_seq_reference(xg.float(), mask.float(), wh.float())
    a1, a2 = lstm_seq(xg, mask, wh), lstm_seq(xg, mask, wh)
    plan = lstm_plan(B, H)
    geo = launch_geometry(B, H, plan["wg"], 0)
    return {"T": T, "B": B, "H": H, "wg": plan["wg"], "cluster": plan["cluster"],
            "ctas": geo["ctas"], "tail_split": geo["tail_split"],
            "waves": round(geo["tiles"] / geo["ctas"], 3), "err": err_of(a1, ref),
            "bit_equal": _equal(a1, a2)}, ref


def run_old(src: str) -> tuple:
    out = os.path.splitext(os.path.abspath(src))[0] + ".so"
    lib = _load(_compile(src, out), src, out, [_P] * 7 + [_I] * 3 + [_P])
    records, ok = [], True
    for T, B, H in OLD_SHAPES:
        xg, mask, wh = inputs(T, B, H)
        rec, ref = _shipped_check(T, B, H, xg, mask, wh)
        rec["old_err"] = err_of(old_call(lib, xg, mask, wh), ref)
        ok &= rec["err"] <= TOL and rec["bit_equal"]
        fns = {"new": lambda: lstm_seq(xg, mask, wh),
               "old": lambda: old_call(lib, xg, mask, wh)}
        times = {}
        for name in ("old", "new", "new", "old"):
            times.setdefault(name, []).append(median_ms(fns[name]))
        h = torch.randn(B, H, device=xg.device).to(torch.bfloat16)
        product = median_ms(lambda: torch.addmm(xg[0], h, wh), iters=20)
        bms, by = bound_ms(T, B, H)
        rec.update({k + "_ms": statistics.median(v) for k, v in times.items()})
        rec.update(speedup_vs_old=rec["old_ms"] / rec["new_ms"], bound_ms=bms, bound_by=by,
                   pct_of_bound=100 * bms / rec["new_ms"], cublas_ms=(T - 1) * product,
                   plain_ms=median_ms(lambda: lstm_seq_reference(xg, mask, wh), iters=5))
        print(json.dumps(rec), flush=True)
        records.append(rec)
        del xg, mask, wh, ref
    return records, ok


def run_variants(out_dir: str) -> tuple:
    text = open(SRC).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: anchor not found: {old!r}")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = _compile(cu, cu[:-3] + ".so")
    argtypes = [_P] * 9 + [ctypes.c_longlong] + [_I] * 5 + [_P]
    libs = {n: _load(p, n, os.path.join(out_dir, n + ".so"), argtypes) for n, p in procs.items()}
    records, ok = [], True
    for T, B, H in VARIANT_SHAPES:
        xg, mask, wh = inputs(T, B, H)
        rec, ref = _shipped_check(T, B, H, xg, mask, wh)
        ok &= rec["err"] <= TOL and rec["bit_equal"]
        names = list(libs)
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                times[n].append(median_ms(lambda: variant_call(libs[n], xg, mask, wh), iters=8))
        shipped = variant_call(libs["shipped"], xg, mask, wh)
        checked = {}
        for n in names:
            if n in CUT:
                continue
            a, b = variant_call(libs[n], xg, mask, wh), variant_call(libs[n], xg, mask, wh)
            diff = (a[1].float() - shipped[1].float()).abs()
            checked[n] = {"err": err_of(a, ref), "bit_equal": _equal(a, b),
                          "share_equal_to_shipped": (a[1] == shipped[1]).float().mean().item(),
                          "mean_diff": diff.mean().item(), "max_diff": diff.max().item()}
            ok &= checked[n]["err"] <= TOL and checked[n]["bit_equal"]
        rec.update(ms={n: statistics.mean(v) for n, v in times.items()}, checked=checked)
        print(json.dumps(rec), flush=True)
        records.append(rec)
        del xg, mask, wh, ref, shipped
    return records, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old", help="an older csrc/lstm.cu (the one-launch-a-step ABI) to time")
    mode.add_argument("--variants", action="store_true", help="time the shipped source's variants")
    ap.add_argument("--out", default=os.path.join("logs", "lstm_variants"),
                    help="where --variants writes its sources and libraries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_cuda_probe needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    records, ok = run_old(args.old) if args.old else run_variants(args.out)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "old" if args.old else "variants"
    with open(os.path.join("chiprun_out", f"lstm_cuda_probe_{name}.json"), "w") as f:
        json.dump({"device": smi, "shapes": records}, f, indent=1)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
