"""Serving CLI of the port: an HTTP answer service over the port's Predictor,
the port of ``vqa_tpu/cli/serve.py``.

  python -m vqa_tpu_torch.cli.serve --dir_logs logs/vqa2/mutan_att \
      [--resume best|latest|<epoch> | --params exported/params.npz | --no_resume] \
      [--path_opt ...] [--host 127.0.0.1] \
      [--port 8080] [--max_batch 64] [--platform cpu] [--dynamic_batching \
      [--batch_wait_ms 5] [--batch_window_ms 40] [--request_timeout_s 30]]
  python -m vqa_tpu_torch.cli.serve --exported exported/ [--coco_dir ...] [...]

Endpoints (JSON over POST, plus GET /healthz and GET /metrics):
  /answer  {"question": str, "image": str, "topk"?: int}
           -> {"answers": [[answer, prob], ...]}
  /batch   {"questions": [str], "images": [str], "topk"?: int}
           -> {"answers": [[[answer, prob], ...], ...]}

The HTTP layer (AnswerService, DynamicBatcher, make_handler, build_server)
is the original's, stdlib only. The port carries its own copy so that the
port, and chip_smoke.py with it, import nothing of the JAX package;
tests/test_torch_serve.py holds the copy to the original on the same
requests. Every forward is padded to ``max_batch`` rows, as in the
original, so a row's answer does not depend on which requests shared its
forward.

Weights: ``--params <npz>`` or ``--no_resume`` serve a '/'-keyed npz (the
given one, or the run's ``model.pretrained_params``; ``python -m
vqa_tpu_torch.cli.export --params external`` writes one, as the JAX
package's export CLI does for a JAX run); otherwise the run's checkpoint
that ``--resume`` names (default ``best``, as in the original), which the
port's train CLI writes under ``<dir_logs>/ckpt``. ``--exported`` serves an
artifact of ``python -m vqa_tpu_torch.cli.export`` instead of a run (no
model code; its batch is the serving batch; ``--coco_dir`` moves its
feature table), moved to the device ``--platform`` names, wherever it was
traced, in float32 or bf16 alike.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

Answers = List[List[Tuple[str, float]]]


class AnswerService:
    """Batched wrapper around a Predictor: one forward at a time, each
    padded to ``max_batch`` rows; larger requests are chunked."""

    def __init__(self, predictor, max_batch: int = 64):
        self.predictor = predictor
        self.max_batch = max_batch
        self._lock = threading.Lock()
        # the counters have their own lock, so /metrics stays readable while
        # a forward holds the device lock
        self._stats_lock = threading.Lock()
        # 'requests' and 'rows' count answer_batch calls (under a
        # DynamicBatcher one call is one coalesced group)
        self._stats = {"requests": 0, "rows": 0, "forwards": 0, "device_seconds": 0.0}

    @property
    def num_answers(self) -> int:
        return self.predictor.dataset.num_answers

    def warmup(self) -> None:
        image = self.predictor.dataset.split.image_names[0]
        self.answer_batch(["warmup question"], [image], topk=1)

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s["rows_per_forward"] = round(s["rows"] / s["forwards"], 2) if s["forwards"] else None
        return s

    def _bump(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def answer_batch(self, questions: Sequence[str], images: Sequence[str],
                     topk: int = 5) -> Answers:
        if len(questions) != len(images):
            raise ValueError(f"{len(questions)} questions vs {len(images)} images")
        out: Answers = []
        with self._lock:  # one device, one queue
            self._bump(requests=1, rows=len(questions))
            for start in range(0, len(questions), self.max_batch):
                q = list(questions[start:start + self.max_batch])
                im = list(images[start:start + self.max_batch])
                n = len(q)
                q += [q[-1]] * (self.max_batch - n)
                im += [im[-1]] * (self.max_batch - n)
                t0 = time.perf_counter()
                out.extend(self.predictor.answer_batch(q, im, topk=topk)[:n])
                self._bump(forwards=1, device_seconds=time.perf_counter() - t0)
        return out


class DynamicBatcher:
    """Coalesces concurrent requests into shared forwards (micro-batching).

    A worker drains queued rows into groups of up to ``max_batch``. A group
    closes ``max_wait_ms`` after its last arrival, and at most ``window_ms``
    (default 8x ``max_wait_ms``) after its first, so a burst of closed-loop
    clients lands in one forward while an idle service adds little latency.
    Same interface as AnswerService."""

    def __init__(self, service: AnswerService, max_wait_ms: float = 5.0,
                 window_ms: Optional[float] = None,
                 request_timeout_s: Optional[float] = None):
        self.service = service
        self.max_wait = max_wait_ms / 1000.0
        self.window = (window_ms if window_ms is not None else 8.0 * max_wait_ms) / 1000.0
        self.request_timeout = request_timeout_s
        self._q: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats = {"client_requests": 0, "client_rows": 0, "groups": 0, "timeouts": 0}
        self._shutdown = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Stop the worker thread (drains nothing: queued requests keep their
        client-side waits). Idempotent."""
        self._shutdown = True
        self._q.put(None)  # wakes the worker's q.get
        self._worker.join(timeout_s)

    @property
    def forwards(self) -> int:  # coalesced group count
        return self._stats["groups"]

    def _bump(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def stats(self) -> dict:
        s = getattr(self.service, "stats", dict)()
        with self._stats_lock:
            b = dict(self._stats)
        b["queue_depth"] = self._q.qsize()
        s["batcher"] = b
        return s

    @property
    def num_answers(self) -> int:
        return self.service.num_answers

    def warmup(self) -> None:
        self.service.warmup()

    def answer_batch(self, questions: Sequence[str], images: Sequence[str],
                     topk: int = 5) -> Answers:
        if len(questions) != len(images):
            raise ValueError(f"{len(questions)} questions vs {len(images)} images")
        done = threading.Event()
        item = {"q": list(questions), "im": list(images), "topk": topk,
                "done": done, "out": None, "err": None, "abandoned": False}
        self._bump(client_requests=1, client_rows=len(questions))
        self._q.put(item)
        # bounded wait: a wedged device would otherwise hang every client
        if not done.wait(self.request_timeout):
            item["abandoned"] = True  # the worker drops it unrun
            self._bump(timeouts=1)
            raise TimeoutError(f"serving backend unresponsive for {self.request_timeout:.0f}s")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _loop(self) -> None:
        max_batch = self.service.max_batch
        carry = None  # an item that did not fit the previous group
        while True:
            if self._shutdown:
                return
            head = carry if carry is not None else self._q.get()
            if head is None or self._shutdown:  # shutdown sentinel
                return
            group, carry = [head], None
            size = len(head["q"])
            cap = time.monotonic() + self.window
            gap_deadline = time.monotonic() + self.max_wait
            while size < max_batch:
                remaining = min(gap_deadline, cap) - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:  # shutdown mid-collection: run this group; the
                    break        # loop head then exits
                if size + len(nxt["q"]) > max_batch:
                    carry = nxt  # seeds the next group: one forward per group
                    break
                group.append(nxt)
                size += len(nxt["q"])
                gap_deadline = time.monotonic() + self.max_wait
            # a request whose client already timed out is not run: its result
            # has no reader, and retries would double the load on recovery
            group = [it for it in group if not it["abandoned"]]
            if not group:
                continue
            qs = [q for it in group for q in it["q"]]
            ims = [im for it in group for im in it["im"]]
            try:
                rows = self.service.answer_batch(qs, ims, topk=max(it["topk"] for it in group))
                self._bump(groups=1)
                pos = 0
                for it in group:
                    n = len(it["q"])
                    it["out"] = [r[:it["topk"]] for r in rows[pos:pos + n]]
                    pos += n
            except Exception:  # isolate the bad request: retry one by one
                for it in group:
                    if it["abandoned"]:
                        continue
                    try:
                        it["out"] = self.service.answer_batch(it["q"], it["im"], topk=it["topk"])
                        self._bump(groups=1)
                    except Exception as e:
                        it["err"] = e
            for it in group:
                it["done"].set()


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        # keep-alive is safe because every response carries Content-Length,
        # and it keeps closed-loop clients out of the kernel's accept queue
        protocol_version = "HTTP/1.1"
        MAX_BODY = 8 * 1024 * 1024  # cap on request buffering

        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/metrics":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                if self.headers.get("Content-Length") is None:
                    self.close_connection = True  # body unread: no reuse
                    self._send(411, {"error": "Content-Length required"})
                    return
                length = int(self.headers["Content-Length"])
                if length > self.MAX_BODY:
                    self.close_connection = True
                    self._send(413, {"error": f"body exceeds {self.MAX_BODY} bytes"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                topk = int(req.get("topk", 5))
                if not 1 <= topk <= service.num_answers:
                    self._send(400, {"error": f"topk must be in [1, {service.num_answers}]"})
                    return
                fields = {"/answer": ("question", "image"),
                          "/batch": ("questions", "images")}.get(self.path)
                if fields is None:
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                # checked here, so that a KeyError from the service (an
                # unknown image) is not taken for a malformed request
                missing = [k for k in fields if k not in req]
                if missing:
                    self._send(400, {"error": f"missing field(s) {missing}"})
                    return
                if self.path == "/answer":
                    answers = service.answer_batch([req["question"]], [req["image"]],
                                                   topk=topk)[0]
                else:
                    answers = service.answer_batch(req["questions"], req["images"], topk=topk)
                self._send(200, {"answers": answers})
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
            except KeyError as e:  # an image missing from the feature table
                self._send(404, {"error": e.args[0] if e.args else str(e)})
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
            except Exception:  # noqa: BLE001 - a fault of the server, not the client
                traceback.print_exc()
                self._send(500, {"error": "internal error"})

    return Handler


class VQAHTTPServer(ThreadingHTTPServer):
    # a deep listen backlog absorbs bursts of new connections while the
    # accept loop waits for the GIL; the stdlib's 5 overflows and resets
    request_queue_size = 1024
    daemon_threads = True


def build_server(service, host: str, port: int) -> ThreadingHTTPServer:
    return VQAHTTPServer((host, port), make_handler(service))


def build_argparser() -> argparse.ArgumentParser:
    """``vqa_tpu/cli/serve.py``'s flags and defaults, and ``--params`` (the
    port's npz)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir_logs", default=None)
    p.add_argument("--exported", default=None,
                   help="serve a vqa_tpu_torch.cli.export artifact dir instead of a run dir")
    p.add_argument("--coco_dir", default=None,
                   help="feature-table dir override for --exported mode")
    p.add_argument("--path_opt", default=None,
                   help="defaults to the run dir's own options.yaml")
    p.add_argument("--params", default=None,
                   help="serve this '/'-keyed params npz (with the seq2vec.pretrained_* "
                        "grafts) instead of the run's checkpoint")
    p.add_argument("--resume", default="best",
                   help="best | latest | <epoch>: the run's checkpoint to serve (under "
                        "<dir_logs>/ckpt), unless --params or --no_resume names an npz")
    p.add_argument("--no_resume", action="store_true",
                   help="serve model.pretrained_params (an npz, with the seq2vec.pretrained_* "
                        "grafts), not a checkpoint")
    p.add_argument("--platform", default=None, metavar="cuda|cpu",
                   help="where to run: the card (default) or, with cpu, the host (an "
                        "--exported artifact moves there from the device it was traced on)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=None,
                   help="serving batch (default 64; fixed by the artifact in --exported mode)")
    p.add_argument("--dynamic_batching", action="store_true",
                   help="coalesce concurrent requests into shared forwards")
    p.add_argument("--batch_wait_ms", type=float, default=5.0,
                   help="coalescing inter-arrival gap: the group closes "
                        "this long after the last queued request")
    p.add_argument("--batch_window_ms", type=float, default=None,
                   help="absolute cap on the coalescing window "
                        "(default 8x batch_wait_ms)")
    p.add_argument("--request_timeout_s", type=float, default=None,
                   help="with --dynamic_batching: bound each request's wait "
                        "(504 instead of hanging behind a wedged device)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    p = build_argparser()
    args = p.parse_args(argv)
    if (args.exported is None) == (args.dir_logs is None):
        p.error("exactly one of --dir_logs / --exported is required")
    if args.request_timeout_s is not None and not args.dynamic_batching:
        p.error("--request_timeout_s requires --dynamic_batching (the plain "
                "service runs the forward on the request thread and cannot "
                "abandon it)")
    if args.platform not in (None, "cuda", "gpu", "cpu"):
        p.error(f"--platform {args.platform!r}: the port serves on the card (cuda) or, with "
                "--platform cpu, on the host")

    device = "cpu" if args.platform == "cpu" else "cuda"
    if args.exported is not None:
        # fail loudly on flags the artifact makes meaningless: a silently
        # ignored --max_batch would serve another batch than asked
        ignored = [name for name, bad in [
            ("--max_batch", args.max_batch is not None),
            ("--path_opt", args.path_opt is not None),
            ("--no_resume", args.no_resume),
            ("--resume", args.resume != "best"),
            ("--params", args.params is not None),
        ] if bad]
        if ignored:
            p.error(f"{', '.join(ignored)} cannot be used with --exported: the artifact fixes "
                    "the batch and already contains the weights")
        from vqa_tpu_torch.export import load_export

        try:
            predictor = load_export(args.exported, coco_dir=args.coco_dir, device=device)
        except ValueError as e:  # a JAX artifact, or one traced for another device
            p.error(str(e))
        max_batch = predictor.batch  # the program's batch is frozen; serve at exactly it
    else:
        from vqa_tpu_torch.predictor import Predictor

        # --params or --no_resume: an npz; otherwise the checkpoint --resume names
        npz = args.params is not None or args.no_resume
        if not npz:
            from vqa_tpu_torch.engine.checkpoint import CheckpointManager

            try:
                CheckpointManager(os.path.join(args.dir_logs, "ckpt")).resolve(args.resume)
            except FileNotFoundError as e:
                p.error(f"{e}: no checkpoint --resume {args.resume} to serve; pass --params "
                        "<npz> or --no_resume (model.pretrained_params) to serve an npz instead")
        predictor = Predictor.from_run(args.dir_logs, args.path_opt, params=args.params,
                                       device=device, resume=None if npz else args.resume)
        max_batch = args.max_batch or 64
    service = AnswerService(predictor, max_batch=max_batch)
    if args.dynamic_batching:
        service = DynamicBatcher(service, max_wait_ms=args.batch_wait_ms,
                                 window_ms=args.batch_window_ms,
                                 request_timeout_s=args.request_timeout_s)
    service.warmup()
    server = build_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch {max_batch})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if args.dynamic_batching:
            service.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
