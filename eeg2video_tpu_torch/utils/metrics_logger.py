"""Structured per-step training metrics: a JSONL writer.

The port's own copy of the JAX package's ``utils/metrics_logger.py``, without
its host-0 filter (the port trains in one process) and without its wandb
backend. The reference logs through accelerate's tracker into wandb
(train_finetune_videodiffusion.py:264-265, 337); here a JSONL file."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, out_dir: str, run_name: str = "train"):
        os.makedirs(out_dir, exist_ok=True)
        self._fh = open(os.path.join(out_dir, f"{run_name}_metrics.jsonl"), "a")

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()
