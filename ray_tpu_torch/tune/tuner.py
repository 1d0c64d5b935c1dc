"""Tuner: the experiment controller.

Reference: ``tune/tuner.py:344`` (Tuner.fit) driving
``tune/execution/tune_controller.py:68,666`` — an event loop that
launches trial actors up to the concurrency limit, polls their result
queues, feeds each report to the scheduler (ASHA may STOP a trial), and
collects everything into a ResultGrid.

TPU-first notes: trials reserve resources through the normal scheduling
path (``resources_per_trial`` may include TPU or a placement-group
strategy), and a TorchTrainer ``fit()`` can be the trainable — the trial
actor is control-plane only, the gang runs under it."""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, STOP, FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants
from ray_tpu_torch.tune.trial import (
    ERRORED,
    PENDING,
    RUNNING,
    STOPPED,
    TERMINATED,
    Trial,
    TrialRunner,
)


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None  # FIFOScheduler | ASHAScheduler | PBT | MedianStopping
    #: a Searcher (TPESearcher/OptunaSearch/RandomSearch, optionally
    #: wrapped in ConcurrencyLimiter): trial configs come from
    #: suggest() sequentially instead of up-front variant expansion
    search_alg: Any = None
    seed: Optional[int] = None


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    status: str
    error: Optional[str] = None


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: Optional[str], mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i: int) -> TrialResult:
        return self._results[i]

    @property
    def errors(self) -> List[TrialResult]:
        return [r for r in self._results if r.status == ERRORED]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric given (set TuneConfig.metric)")
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = {"trial_id": r.trial_id, "status": r.status}
            row.update({f"config/{k}": v for k, v in r.config.items() if not isinstance(v, dict)})
            row.update(r.metrics)
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    """``Tuner(trainable, param_space=..., tune_config=...).fit()``.

    ``trainable`` is a function ``fn(config) -> None|dict`` reporting via
    ``ray_tpu_torch.tune.report`` — or an object with ``.fit()`` and a
    ``train_loop_config`` attribute (e.g. TorchTrainer), run per-trial with
    the variant config merged into its loop config."""

    def __init__(
        self,
        trainable: Any,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        run_config: Any = None,  # train.RunConfig: name + storage_path
    ):
        self._trainable = self._as_function(trainable)
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.resources_per_trial = resources_per_trial or {"CPU": 1.0}
        self.run_config = run_config
        self._restored_trials: Optional[List[Trial]] = None

    # -- experiment snapshot/resume (reference experiment_state.py) -----
    def _snapshot_path(self) -> Optional[str]:
        rc = self.run_config
        if rc is None or not getattr(rc, "storage_path", None):
            return None
        name = getattr(rc, "name", None) or "tune_experiment"
        return os.path.join(rc.storage_path, name, "tuner.pkl")

    def _save_snapshot(self, trials: List[Trial]) -> None:
        path = self._snapshot_path()
        if path is None:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        state = {
            "param_space": self.param_space,
            "tune_config": self.tune_config,
            "resources_per_trial": self.resources_per_trial,
            "run_config": self.run_config,
            "trials": [
                Trial(
                    trial_id=t.trial_id,
                    config=t.config,
                    status=t.status,
                    last_metrics=t.last_metrics,
                    metrics_history=list(t.metrics_history),
                    iterations=t.iterations,
                    error=t.error,
                    last_checkpoint=t.last_checkpoint,
                )
                for t in trials
            ],
        }
        tmp = path + ".tmp"
        try:
            import cloudpickle  # schedulers may hold lambdas (PBT mutations)

            with open(tmp, "wb") as f:
                cloudpickle.dump(state, f)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — a snapshot must never kill a sweep
            import logging

            logging.getLogger(__name__).exception("experiment snapshot failed")
            try:
                os.remove(tmp)
            except OSError:
                pass

    @classmethod
    def restore(cls, path: str, trainable: Any) -> "Tuner":
        """Resume a killed/crashed sweep from its snapshot (reference
        ``Tuner.restore``): finished trials keep their results;
        unfinished ones restart from their latest reported checkpoint."""
        if os.path.isdir(path):
            path = os.path.join(path, "tuner.pkl")
        import cloudpickle

        with open(path, "rb") as f:
            state = cloudpickle.load(f)
        tuner = cls(
            trainable,
            param_space=state["param_space"],
            tune_config=state["tune_config"],
            resources_per_trial=state["resources_per_trial"],
            run_config=state["run_config"],
        )
        tuner._restored_trials = state["trials"]
        return tuner

    @staticmethod
    def _as_function(trainable: Any) -> Callable[[Dict[str, Any]], Any]:
        if callable(trainable):
            return trainable
        if hasattr(trainable, "fit"):
            # Trainer-as-trainable (reference train/base_trainer.py:608):
            # merge the variant into train_loop_config, run the gang, and
            # report the final metrics.
            import copy
            import dataclasses

            def run_trainer(config: Dict[str, Any]):
                from ray_tpu_torch.tune.trial import get_trial_id

                trainer = copy.copy(trainable)
                merged = dict(getattr(trainer, "_train_config", None) or {})
                merged.update(config)
                trainer._train_config = merged
                # Per-trial run dir: trials must not share checkpoint
                # state (a shared dir would make trial 2 silently resume
                # trial 1's checkpoint with different hyperparameters).
                rc = getattr(trainer, "run_config", None)
                if rc is not None:
                    trainer.run_config = dataclasses.replace(
                        rc, name=f"{rc.name or 'tune'}-{get_trial_id()}"
                    )
                result = trainer.fit()
                return dict(result.metrics)

            return run_trainer
        raise TypeError(f"trainable must be callable or have .fit(): {trainable!r}")

    def fit(self) -> ResultGrid:
        cfg = self.tune_config
        scheduler = cfg.scheduler or FIFOScheduler()
        # Resolve scheduler metric/mode from TuneConfig (reference: Tuner
        # owns them unless the scheduler explicitly overrides) — a default
        # ASHAScheduler() in a min-mode experiment must rank by min.
        if getattr(scheduler, "mode", "x") is None:
            scheduler.mode = cfg.mode
        metric = getattr(scheduler, "metric", None) or cfg.metric
        search = cfg.search_alg
        if search is not None:
            search.set_search_properties(cfg.metric, cfg.mode, self.param_space)
        callbacks = list(getattr(self.run_config, "callbacks", None) or [])
        exp_dir = None
        rc = self.run_config
        if rc is not None and getattr(rc, "storage_path", None):
            exp_dir = os.path.join(
                rc.storage_path, getattr(rc, "name", None) or "tune_experiment"
            )
        for cb in callbacks:
            setup = getattr(cb, "setup", None)
            if setup is not None:
                setup(exp_dir)

        def notify_complete(t: Trial) -> None:
            scheduler.on_trial_complete(t.trial_id)
            if search is not None:
                search.on_trial_complete(t.trial_id, t.last_metrics or {})
            for cb in callbacks:
                try:
                    cb.on_trial_complete(t)
                except Exception:
                    pass

        if self._restored_trials is not None:
            trials = self._restored_trials
            # unfinished trials restart (from their latest checkpoint)
            pending = []
            for t in trials:
                if t.status in (PENDING, RUNNING):
                    t.status = PENDING
                    t.actor = None
                    pending.append(t)
        elif search is not None:
            # sequential suggestion: trials materialize as slots open so
            # the searcher can condition on completed results
            trials = []
            pending = []
        else:
            variants = generate_variants(
                self.param_space, num_samples=cfg.num_samples, seed=cfg.seed
            )
            trials = [
                Trial(trial_id=f"trial_{i:04d}_{uuid.uuid4().hex[:6]}", config=v)
                for i, v in enumerate(variants)
            ]
            pending = list(trials)
        to_suggest = 0
        if search is not None:
            if self._restored_trials is None:
                to_suggest = cfg.num_samples
            else:
                # resume: replay completed trials into the searcher so
                # its model warm-starts, then suggest the REMAINING
                # budget (not zero — that would silently truncate).
                # add_evaluated_point, NOT on_trial_complete: restored
                # trial ids were never suggest()-ed in this process, so
                # id-keyed completion is a silent no-op for TPE/Optuna
                # (their live-trial maps are empty after a restart).
                for t in trials:
                    if t.status in (TERMINATED, STOPPED, ERRORED) and t.last_metrics:
                        search.add_evaluated_point(t.config, t.last_metrics)
                to_suggest = max(0, cfg.num_samples - len(trials))
        trials_by_id = {t.trial_id: t for t in trials}
        launching: List[tuple] = []  # (trial, run_ref): actor may be queued
        running: List[Trial] = []
        opts = dict(self.resources_per_trial)
        num_cpus = opts.pop("CPU", 1.0)
        last_snapshot = 0.0

        def launch(t: Trial) -> None:
            t.actor = TrialRunner.options(
                num_cpus=num_cpus, resources=opts or None
            ).remote()
            # Fire-and-track: the actor may wait arbitrarily long for
            # cluster capacity — a blocking get() here would stall the
            # poll loop (frozen ASHA decisions) and crash the sweep on
            # an oversubscribed cluster.
            launching.append(
                (
                    t,
                    t.actor.run.remote(
                        self._trainable, t.config, t.trial_id, t.last_checkpoint
                    ),
                )
            )

        while pending or launching or running or to_suggest > 0:
            now = time.monotonic()
            if now - last_snapshot > 2.0:
                last_snapshot = now
                self._save_snapshot(trials)
            while pending and len(launching) + len(running) < cfg.max_concurrent_trials:
                launch(pending.pop(0))
            while (
                to_suggest > 0
                and len(launching) + len(running) < cfg.max_concurrent_trials
            ):
                tid = f"trial_{len(trials):04d}_{uuid.uuid4().hex[:6]}"
                config = search.suggest(tid)
                if config is None:
                    break  # ConcurrencyLimiter: wait for a completion
                t = Trial(trial_id=tid, config=config)
                trials.append(t)
                trials_by_id[tid] = t
                to_suggest -= 1
                launch(t)

            still_launching: List[tuple] = []
            for t, run_ref in launching:
                done, _ = ray_tpu_torch.wait([run_ref], num_returns=1, timeout=0)
                if not done:
                    still_launching.append((t, run_ref))
                    continue
                try:
                    ray_tpu_torch.get(run_ref, timeout=10)
                    t.status = RUNNING
                    running.append(t)
                except Exception as e:  # noqa: BLE001
                    t.status = ERRORED
                    t.error = f"trial actor failed to start: {e!r}"
                    notify_complete(t)
                    try:
                        ray_tpu_torch.kill(t.actor)  # release its reservation
                    except Exception:
                        pass
            launching = still_launching

            still_running: List[Trial] = []
            for t in running:
                # Per-trial poll: one actor dying (worker OOM/crash) must
                # mark THAT trial errored, not blow up the whole sweep.
                try:
                    poll = ray_tpu_torch.get(t.actor.poll.remote(), timeout=120)
                except Exception as e:  # noqa: BLE001
                    t.status = ERRORED
                    t.error = f"trial actor died: {e!r}"
                    notify_complete(t)
                    continue
                stop = False
                exploit_src: Optional[str] = None
                checkpoints = poll.get("checkpoints") or [None] * len(poll["reports"])
                for report, ck in zip(poll["reports"], checkpoints):
                    # every drained report is recorded and fed to the
                    # scheduler even after a decision fires — a batch must
                    # never silently truncate history/checkpoints
                    t.iterations += 1
                    t.last_metrics = report
                    t.metrics_history.append(report)
                    if ck is not None:
                        t.last_checkpoint = ck
                    for cb in callbacks:
                        try:
                            cb.on_trial_result(t, report)
                        except Exception:
                            pass
                    value = report.get(metric) if metric else None
                    if value is not None and not stop and exploit_src is None:
                        decision = scheduler.on_result(
                            t.trial_id, t.iterations, float(value)
                        )
                        if decision == STOP:
                            stop = True
                        elif (
                            isinstance(decision, tuple)
                            and decision[0] == EXPLOIT
                        ):
                            exploit_src = decision[1]
                if exploit_src is not None and not stop:
                    # PBT exploit/explore: restart from the top peer's
                    # checkpoint with a mutated copy of its config
                    src = trials_by_id.get(exploit_src)
                    if src is not None and src.last_checkpoint is not None:
                        ray_tpu_torch.kill(t.actor)
                        t.config = scheduler.explore(dict(src.config))
                        t.last_checkpoint = src.last_checkpoint
                        t.status = PENDING
                        pending.append(t)
                        continue
                    # source has nothing to exploit yet: keep running
                    still_running.append(t)
                    continue
                if stop:
                    t.status = STOPPED
                    notify_complete(t)
                    ray_tpu_torch.kill(t.actor)
                elif poll["error"] is not None and not poll["reports"]:
                    t.status = ERRORED
                    t.error = poll["error"]
                    notify_complete(t)
                    ray_tpu_torch.kill(t.actor)
                elif poll["done"] and not poll["reports"]:
                    t.status = TERMINATED
                    notify_complete(t)
                    ray_tpu_torch.kill(t.actor)
                else:
                    still_running.append(t)
            running = still_running
            if pending or launching or running:
                time.sleep(0.02)

        self._save_snapshot(trials)
        return ResultGrid(
            [
                TrialResult(
                    trial_id=t.trial_id,
                    config=t.config,
                    metrics=t.last_metrics,
                    metrics_history=t.metrics_history,
                    status=t.status,
                    error=t.error,
                )
                for t in trials
            ],
            cfg.metric,
            cfg.mode,
        )
