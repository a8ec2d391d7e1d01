"""The reduction of a ``torch.profiler`` Chrome trace to the numbers the
per-layer readers take.

The busy time is the union of the kernel intervals and the kernel classes
are frozen copies of ``vqa_tpu_torch/tools/profile_eval.py``'s
(``CLASSES``, ``_classify``, the interval union of ``profile``). A kernel
belongs to the registered op of the program (``vqa_tpu_torch::<name>``)
whose host interval holds the kernel's launch, found through the trace's
correlation ids, so an op's device time reads the same whichever design
(and kernel names) serves the call. An idle gap of the device is labelled
by what the host's main thread was doing at its middle: the innermost of
the harness's spans (``portbench.*``) and the innermost op or runtime
call there, or ``python`` where none ran.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
from typing import Dict, List, Optional, Tuple

# kernel name -> class; the first pattern that matches wins
CLASSES = (
    ("lstm_seq", r"lstm_seq_kernel|lstm_step_kernel"),
    ("gather_rows_dequant", r"gather_rows_dequant"),
    ("gather_rows", r"gather_rows"),
    ("glimpse", r"glimpse"),
    ("mfb_pool", r"mfb_pool"),
    ("relation_attend", r"relation"),
    ("gemm", r"gemm|nvjet|cutlass|sm80_|sm90_|cublas|xmma"),
    ("reduction", r"reduce|Reduce|softmax|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
)
ELEM = {"c10::BFloat16": 2, "BFloat16": 2, "c10::Half": 2, "float": 4, "Float": 4}
WALK = 400  # host events looked back through for the one holding a gap


def classify(name: str) -> str:
    for cls, pattern in CLASSES:
        if re.search(pattern, name):
            return cls
    return "other"


def union_us(spans: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of ``spans`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for s, e in sorted(spans):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


class Trace:
    """One traced window: the kernels, and where the host was traced too, its
    main thread's events. With host events the span ``portbench.traced``
    bounds the window; a trace of the device alone takes the window's
    length from the host clock (``window_us``) and holds every kernel."""

    def __init__(self, events: List[dict], window_us: Optional[float] = None,
                 window: str = "portbench.traced"):
        self.kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
        self.host, self.marks, self.launch_ts = [], [], {}
        self.device_only = window_us is not None
        if self.device_only:
            self.lo = min((float(k["ts"]) for k in self.kernels), default=0.0)
            self.hi = self.lo + window_us
            self.starts, self.mark_starts = [], []
            return
        marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == window]
        if not marks:
            raise ValueError(f"the trace has no {window!r} span")
        mark = marks[0]
        self.lo, self.hi = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        tid = mark["tid"]
        host = [e for e in events if e.get("ph") == "X" and e.get("tid") == tid
                and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")]
        host.sort(key=lambda e: float(e["ts"]))
        self.host = host
        self.starts = [float(e["ts"]) for e in host]
        self.marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][10:])
                      for e in host if e["cat"] == "user_annotation"
                      and e["name"].startswith("portbench.") and e["name"] != window]
        self.mark_starts = [m[0] for m in self.marks]
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                self.launch_ts[corr] = float(e["ts"])
        self.kernels = [k for k in self.kernels if self.lo <= float(k["ts"]) <= self.hi]

    @classmethod
    def load(cls, path: str, window_us: Optional[float] = None) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], window_us)

    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        spans = [(float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in self.kernels]
        if self.device_only:   # every kernel ran inside the host's window
            return union_us(spans, float("-inf"), float("inf"))
        return union_us(spans, self.lo, self.hi)

    def device_ops(self, top: int = 10) -> List[list]:
        """The kernels that took the most device time, by name: [name, s]."""
        by = collections.Counter()
        for k in self.kernels:
            by[k["name"]] += float(k["dur"])
        return [[name, us / 1e6] for name, us in by.most_common(top)]

    def by_class(self) -> Dict[str, float]:
        """Device time by kernel class (``CLASSES``), in ms, largest first."""
        by = collections.Counter()
        for k in self.kernels:
            by[classify(k["name"])] += float(k["dur"]) / 1e3
        return dict(by.most_common())

    def _spans(self, name: str) -> List[Tuple[float, float, dict]]:
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e) for e in self.host
                if e["name"] == name]

    def _by_span(self, name: str) -> Tuple[List[dict], List[List[dict]]]:
        """The host spans ``name`` (not nested in each other) and, for each,
        the kernels launched inside it."""
        spans = self._spans(name)
        starts = [s for s, _, _ in spans]
        owned: List[List[dict]] = [[] for _ in spans]
        for k in self.kernels:
            ts = self.launch_ts.get((k.get("args") or {}).get("correlation"))
            i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
            if i >= 0 and ts <= spans[i][1]:
                owned[i].append(k)
        return [e for _, _, e in spans], owned

    def op_calls(self, op: str) -> List[Tuple[dict, float]]:
        """Each call of the registered op ``op`` in the window that launched
        kernels, with their device time: [(host event, us)]."""
        events, owned = self._by_span(op)
        return [(e, sum(float(k["dur"]) for k in ks)) for e, ks in zip(events, owned) if ks]

    def kernels_per_span(self, name: str) -> List[int]:
        """The kernels launched inside each host span ``name``."""
        return [len(ks) for ks in self._by_span(name)[1]]

    def _label(self, t: float) -> str:
        op = None
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - WALK, -1), -1):
            e = self.host[j]
            if e["cat"] != "user_annotation" and float(e["ts"]) + float(e["dur"]) >= t:
                op = e["name"]
                break
        span = None
        i = bisect.bisect_right(self.mark_starts, t) - 1
        for j in range(i, max(i - 4 * WALK, -1), -1):
            start, end, name = self.marks[j]
            if end >= t:
                span = name
                break
        return f"{span or 'traced'}: {op or 'python'}"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the window, summed by what the host was
        doing: [label, s], the largest first."""
        spans = sorted((float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in self.kernels)
        gaps, end = [], self.lo
        for s, e in spans + [(self.hi, self.hi)]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        by = collections.Counter()
        for a, b in gaps:
            by[self._label((a + b) / 2)] += b - a
        return [[label, us / 1e6] for label, us in by.most_common(top)]


def input_dims(event: dict) -> List[list]:
    return (event.get("args") or {}).get("Input Dims") or []


def input_elem(event: dict) -> int:
    types = (event.get("args") or {}).get("Input type") or ["c10::BFloat16"]
    return ELEM.get(types[0], 2)
