"""Logger callbacks: per-trial progress to CSV / JSONL / TensorBoard.

Reference: ``tune/logger/`` (CSV/JSON/TBX logger callbacks wired
through ``RunConfig.callbacks``). Each trial gets a directory under the
experiment dir; every reported result appends a row/event.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class LoggerCallback:
    """Callback ABC (reference ``tune/logger/logger.py`` LoggerCallback)."""

    def setup(self, experiment_dir: Optional[str]) -> None:
        self.experiment_dir = experiment_dir

    def _trial_dir(self, trial) -> Optional[str]:
        if not getattr(self, "experiment_dir", None):
            return None
        d = os.path.join(self.experiment_dir, trial.trial_id)
        os.makedirs(d, exist_ok=True)
        return d

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass


class CSVLoggerCallback(LoggerCallback):
    """``progress.csv`` per trial (reference CSVLoggerCallback). Columns
    fix on the first result; later keys outside them are dropped (the
    reference behaves the same)."""

    def setup(self, experiment_dir):
        super().setup(experiment_dir)
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}

    def on_trial_result(self, trial, result):
        import csv

        d = self._trial_dir(trial)
        if d is None:
            return
        w = self._writers.get(trial.trial_id)
        if w is None:
            f = open(os.path.join(d, "progress.csv"), "w", newline="")
            fields = list(result.keys())
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            self._writers[trial.trial_id] = w
            self._files[trial.trial_id] = f
        w.writerow({k: result.get(k) for k in w.fieldnames})
        self._files[trial.trial_id].flush()

    def on_trial_complete(self, trial):
        f = self._files.pop(trial.trial_id, None)
        self._writers.pop(trial.trial_id, None)
        if f is not None:
            f.close()


class JSONLoggerCallback(LoggerCallback):
    """``result.json`` (JSON-lines) per trial + ``params.json``."""

    def on_trial_result(self, trial, result):
        d = self._trial_dir(trial)
        if d is None:
            return
        params = os.path.join(d, "params.json")
        if not os.path.exists(params):
            with open(params, "w") as f:
                json.dump(trial.config, f, default=str)
        with open(os.path.join(d, "result.json"), "a") as f:
            f.write(json.dumps(result, default=str) + "\n")


class TensorBoardLoggerCallback(LoggerCallback):
    """TensorBoard event files per trial (reference TBXLoggerCallback).
    Uses torch's SummaryWriter; raises at construction if unavailable."""

    def __init__(self):
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401

        self._writer_cls = SummaryWriter
        self._writers: Dict[str, Any] = {}

    def on_trial_result(self, trial, result):
        d = self._trial_dir(trial)
        if d is None:
            return
        w = self._writers.get(trial.trial_id)
        if w is None:
            w = self._writers[trial.trial_id] = self._writer_cls(log_dir=d)
        step = int(result.get("training_iteration", len(trial.metrics_history)))
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                w.add_scalar(k, v, global_step=step)
        w.flush()

    def on_trial_complete(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()
