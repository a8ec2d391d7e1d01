"""Experiment logger, a copy of ``vqa_tpu/engine/logger.py`` (the port imports
nothing of the JAX package): structured JSONL metrics, the same run layout.

Layout under logs/<exp>/:
  options.yaml       merged config (written by the CLI for provenance)
  metrics.jsonl      one record per (epoch, split) with meter averages
  steps.jsonl        optional per-print_freq step records
  results/           OpenEnded results json per epoch
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class Experiment:
    def __init__(self, dir_logs: str, resume: bool = False):
        """Always appends: re-running a CLI against an existing run dir (a
        fresh eval, an accidental restart) must never truncate the metric
        history. ``resume`` only controls whether a run_start marker notes
        the restart kind."""
        self.dir_logs = dir_logs
        os.makedirs(dir_logs, exist_ok=True)
        os.makedirs(os.path.join(dir_logs, "results"), exist_ok=True)
        metrics_path = os.path.join(dir_logs, "metrics.jsonl")
        had_history = os.path.exists(metrics_path) and os.path.getsize(metrics_path) > 0
        self._metrics = open(metrics_path, "a")
        self._steps = open(os.path.join(dir_logs, "steps.jsonl"), "a")
        if had_history:
            rec = {"ts": time.time(), "event": "run_start", "resume": bool(resume)}
            self._metrics.write(json.dumps(rec) + "\n")
            self._metrics.flush()

    def log_step(self, epoch: int, split: str, step: int, values: Dict[str, float]):
        rec = {"ts": time.time(), "epoch": epoch, "split": split, "step": step, **values}
        self._steps.write(json.dumps(rec) + "\n")
        self._steps.flush()

    def log_epoch(self, epoch: int, split: str, values: Dict[str, float]):
        rec = {"ts": time.time(), "epoch": epoch, "split": split, **values}
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()

    def write_results(
        self, results: List[Dict[str, Any]], epoch: int, split: str
    ) -> str:
        """OpenEnded results json ([{question_id, answer}]) per epoch."""
        path = os.path.join(
            self.dir_logs, "results", f"vqa_OpenEnded_{split}_epoch{epoch}_results.json"
        )
        with open(path, "w") as f:
            json.dump(results, f)
        return path

    def history(self, split: Optional[str] = None) -> List[Dict[str, Any]]:
        path = os.path.join(self.dir_logs, "metrics.jsonl")
        out = []
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("event"):
                    continue
                if split is None or rec.get("split") == split:
                    out.append(rec)
        return out

    def close(self):
        self._metrics.close()
        self._steps.close()
