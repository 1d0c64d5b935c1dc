"""Trial schedulers: FIFO + ASHA early stopping.

Reference: ``tune/schedulers/async_hyperband.py:19`` — Async Successive
Halving (ASHA): rungs at ``grace_period * reduction_factor^k``; when a
trial reports at a rung milestone it continues only if its metric is in
the top ``1/reduction_factor`` quantile of everything that has reached
that rung; everyone else stops. Asynchronous: no waiting for a full
bracket — decisions use whatever peers have arrived."""

from __future__ import annotations

from typing import Dict, List

CONTINUE = "CONTINUE"
STOP = "STOP"
#: (EXPLOIT, source_trial_id): restart this trial from source's checkpoint
#: with an explored config (PBT)
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    """No early stopping: every trial runs to completion."""

    def on_result(self, trial_id: str, iteration: int, metric_value: float) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class ASHAScheduler:
    def __init__(
        self,
        *,
        metric: str | None = None,
        mode: str | None = None,
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
    ):
        if mode not in (None, "min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        #: metric/mode may be left None and inherited from TuneConfig —
        #: the Tuner resolves them before the first on_result call.
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> {trial_id: best metric recorded at this rung}
        self._rungs: Dict[int, Dict[str, float]] = {}
        milestone = grace_period
        while milestone < max_t:
            self._rungs[milestone] = {}
            milestone *= reduction_factor

    def _milestones(self) -> List[int]:
        return sorted(self._rungs)

    def on_result(self, trial_id: str, iteration: int, metric_value: float) -> str:
        v = -metric_value if self.mode == "min" else metric_value
        for milestone in self._milestones():
            if iteration < milestone:
                break
            rung = self._rungs[milestone]
            if trial_id in rung:
                continue  # already judged at this rung
            rung[trial_id] = v
            # top-1/rf cutoff among peers that reached the rung
            values = sorted(rung.values(), reverse=True)
            k = max(1, len(values) // self.rf)
            cutoff = values[k - 1]
            if v < cutoff:
                return STOP
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class PopulationBasedTraining:
    """PBT (reference ``tune/schedulers/pbt.py:221``): every
    ``perturbation_interval`` iterations, a trial in the bottom quantile
    EXPLOITS a top-quantile peer — the Tuner restarts it from the peer's
    checkpoint — and EXPLORES a mutated copy of the peer's config.

    Requires trainables that checkpoint via
    ``tune.report(metrics, checkpoint=...)`` and resume via
    ``tune.get_checkpoint()``; trials that never checkpoint are skipped
    (nothing to exploit)."""

    def __init__(
        self,
        *,
        metric: str | None = None,
        mode: str | None = None,
        perturbation_interval: int = 4,
        quantile_fraction: float = 0.25,
        hyperparam_mutations: Dict[str, object] | None = None,
        seed: int | None = None,
    ):
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.metric = metric
        self.mode = mode
        self.interval = max(1, perturbation_interval)
        self.quantile = quantile_fraction
        self.mutations = dict(hyperparam_mutations or {})
        import random as _random

        self._rng = _random.Random(seed)
        #: trial_id -> latest signed score (mode-normalized; higher=better)
        self._scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = {}
        self._complete: set = set()

    def on_result(self, trial_id: str, iteration: int, metric_value: float):
        v = -metric_value if self.mode == "min" else metric_value
        self._scores[trial_id] = v
        last = self._last_perturb.get(trial_id, 0)
        if iteration - last < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = iteration
        live = {
            t: s for t, s in self._scores.items() if t not in self._complete
        }
        if len(live) < 2:
            return CONTINUE
        ranked = sorted(live, key=lambda t: live[t], reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        bottom = set(ranked[-k:])
        if trial_id not in bottom:
            return CONTINUE
        top = [t for t in ranked[:k] if t != trial_id]
        if not top:
            return CONTINUE
        return (EXPLOIT, self._rng.choice(top))

    def explore(self, config: Dict[str, object]) -> Dict[str, object]:
        """Mutate an exploited config (reference ``explore()``): resample
        from a list/callable, or perturb numerics by 0.8x / 1.2x."""
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(spec):
                out[key] = spec()
            elif isinstance(spec, (list, tuple)):
                out[key] = self._rng.choice(list(spec))
            elif isinstance(out.get(key), (int, float)):
                factor = self._rng.choice((0.8, 1.2))
                val = out[key] * factor
                # ints ROUND (int() would truncate 1*0.8 to the absorbing 0)
                out[key] = (
                    int(round(val)) if isinstance(config[key], int) else val
                )
        return out

    def on_trial_complete(self, trial_id: str) -> None:
        self._complete.add(trial_id)


class MedianStoppingRule:
    """Median stopping (reference
    ``tune/schedulers/median_stopping_rule.py:19``): stop a trial at
    iteration t if its best metric so far is worse than the MEDIAN of
    the other trials' running averages at comparable progress."""

    def __init__(
        self,
        *,
        metric: str | None = None,
        mode: str | None = None,
        grace_period: int = 4,
        min_samples_required: int = 3,
    ):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        #: trial_id -> list of signed metric values per report
        self._histories: Dict[str, List[float]] = {}

    def on_result(self, trial_id: str, iteration: int, metric_value: float) -> str:
        v = -metric_value if self.mode == "min" else metric_value
        hist = self._histories.setdefault(trial_id, [])
        hist.append(v)
        if iteration < self.grace_period:
            return CONTINUE
        # running averages of OTHER trials truncated to this progress
        others = [
            sum(h[:iteration]) / min(len(h), iteration)
            for t, h in self._histories.items()
            if t != trial_id and h
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        if max(hist) < median:
            return STOP
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass
