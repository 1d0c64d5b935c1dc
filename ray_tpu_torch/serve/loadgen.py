"""Trace-driven chaos load harness (the SLO autopilot's test bench).

Replays production-shaped traffic against a multi-replica deployment —
heavy-tailed prompt/output lengths (bounded Pareto), bursty + diurnal
arrival processes (nonhomogeneous Poisson via thinning), a tenant mix
with priority classes, and shared-prefix populations that exercise the
radix cache — while the three seeded fault plans (``RpcFaultPlan``,
``DataFaultPlan``, ``ReplicaFaultPlan``, armed through the ONE master
chaos seed) inject kills, stalls and data-plane corruption underneath.

Determinism contract: :func:`build_trace` is a PURE function of the
:class:`LoadSpec` — every draw comes from one ``random.Random(seed)``
stream in a fixed order, so the same spec is bit-identical arrivals,
tenants, prompts and output lengths, run after run. Together with the
master chaos seed (``util/chaos.py::derive_plan_seed``) a whole harness
run — traffic AND fault schedule — reproduces from one logged line
(:func:`repro_line`).

Scoring (:func:`score`) turns a run into SLO attainment: TTFT/ITL
p99/p99.9 against budgets, goodput fraction from ``serve.slo_report()``,
autoscaler lag from the controller's ``last_scale`` stamp, and every
miss attributed to a named stage via the flight recorder
(:func:`attribute_misses`).

Methodology follows the Ray paper's fault-recovery-under-load runs
(arXiv:1712.05889 §5.4) and the goodput-per-chip serving-economics
framing of arXiv:2605.25645."""

from __future__ import annotations

import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ray_tpu_torch.serve.ingress import IngressShedError, http_stream, pick_ingress

#: tenant classes in priority order (must mirror ingress CLASS_PRIORITY)
_CLASSES = ("interactive", "standard", "batch")


@dataclass
class LoadSpec:
    """Everything a harness run is a function of. One seed, one line."""

    seed: int = 1
    #: trace horizon (scheduled-arrival seconds, before ``time_scale``)
    duration_s: float = 10.0
    # -- arrival process --------------------------------------------------
    base_rate_rps: float = 8.0
    #: diurnal swing: rate *= 1 + amplitude*sin(2πt/period) (clamped <1)
    diurnal_period_s: float = 60.0
    diurnal_amplitude: float = 0.5
    #: bursts: rate *= burst_factor during the first ``burst_duty``
    #: fraction of every ``burst_period_s`` window
    burst_period_s: float = 20.0
    burst_duty: float = 0.2
    burst_factor: float = 3.0
    # -- tenant mix -------------------------------------------------------
    n_tenants: int = 8
    #: zipf-ish per-tenant traffic share: weight_i = 1/(i+1)^a
    tenant_zipf_a: float = 1.2
    class_weights: Dict[str, float] = field(
        default_factory=lambda: {"interactive": 0.5, "standard": 0.3, "batch": 0.2}
    )
    # -- request shapes (bounded Pareto) ----------------------------------
    prompt_alpha: float = 1.3
    prompt_min: int = 4
    prompt_max: int = 64
    output_alpha: float = 1.5
    output_min: int = 2
    output_max: int = 32
    # -- shared-prefix populations (radix-cache exercise) -----------------
    n_prefixes: int = 4
    prefix_len: int = 12
    #: probability a request leads with its tenant group's shared prefix
    prefix_reuse: float = 0.7
    vocab: int = 250
    # -- seeded chaos (injected while the trace replays) ------------------
    #: master seed: derives every armed plan's seed (util/chaos.py)
    chaos_master_seed: int = 0
    rpc_chaos: str = ""
    pull_chaos: str = ""
    replica_chaos: str = ""


@dataclass
class TraceRequest:
    index: int
    t_s: float  # scheduled arrival, seconds from run start
    tenant: str
    tenant_class: str
    prompt: List[int]
    max_new_tokens: int
    request_id: str


def _bounded_pareto(rnd: random.Random, alpha: float, lo: int, hi: int) -> int:
    """Inverse-CDF bounded Pareto draw — the heavy-tailed length
    distribution production prompt/output sizes actually follow."""
    lo_f, hi_f = float(lo), float(max(lo, hi))
    if hi_f <= lo_f:
        return int(lo_f)
    u = rnd.random()
    ratio = (lo_f / hi_f) ** alpha
    x = lo_f / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)
    return max(lo, min(int(hi), int(x)))


def _rate_at(spec: LoadSpec, t: float) -> float:
    amp = min(0.95, max(0.0, spec.diurnal_amplitude))
    rate = spec.base_rate_rps * (
        1.0 + amp * math.sin(2.0 * math.pi * t / max(spec.diurnal_period_s, 1e-6))
    )
    if spec.burst_period_s > 0 and (
        t % spec.burst_period_s
    ) < spec.burst_duty * spec.burst_period_s:
        rate *= spec.burst_factor
    return max(rate, 1e-9)


def build_trace(spec: LoadSpec) -> List[TraceRequest]:
    """The full request schedule, as a pure function of the spec. Draw
    order is part of the replay contract — do not reorder the RNG
    consumption below."""
    rnd = random.Random(spec.seed)
    # tenant population: class per tenant, zipf traffic weights, shared
    # prefix per tenant GROUP (tenants i, i+n_prefixes, ... share one)
    classes = [c for c in _CLASSES if spec.class_weights.get(c, 0.0) > 0.0]
    cweights = [spec.class_weights[c] for c in classes]
    tenants = [f"t{i:02d}" for i in range(max(1, spec.n_tenants))]
    tenant_class = {t: rnd.choices(classes, weights=cweights)[0] for t in tenants}
    tweights = [1.0 / (i + 1) ** spec.tenant_zipf_a for i in range(len(tenants))]
    n_groups = max(1, spec.n_prefixes)
    prefixes = [
        [rnd.randrange(1, max(2, spec.vocab)) for _ in range(spec.prefix_len)]
        for _ in range(n_groups)
    ]
    # arrivals: nonhomogeneous Poisson by thinning against the peak rate
    peak = (
        spec.base_rate_rps
        * (1.0 + min(0.95, max(0.0, spec.diurnal_amplitude)))
        * max(1.0, spec.burst_factor)
    )
    trace: List[TraceRequest] = []
    t = 0.0
    while True:
        t += rnd.expovariate(peak)
        if t >= spec.duration_s:
            break
        if rnd.random() >= _rate_at(spec, t) / peak:
            continue  # thinned (the draw still happened — determinism)
        i = len(trace)
        tenant_i = rnd.choices(range(len(tenants)), weights=tweights)[0]
        tenant = tenants[tenant_i]
        n_prompt = _bounded_pareto(
            rnd, spec.prompt_alpha, spec.prompt_min, spec.prompt_max
        )
        use_prefix = rnd.random() < spec.prefix_reuse
        fresh = max(1, n_prompt - (spec.prefix_len if use_prefix else 0))
        tail = [rnd.randrange(1, max(2, spec.vocab)) for _ in range(fresh)]
        prompt = (
            list(prefixes[tenant_i % n_groups]) + tail if use_prefix else tail
        )
        trace.append(
            TraceRequest(
                index=i,
                t_s=t,
                tenant=tenant,
                tenant_class=tenant_class[tenant],
                prompt=prompt,
                max_new_tokens=_bounded_pareto(
                    rnd, spec.output_alpha, spec.output_min, spec.output_max
                ),
                request_id=f"lg{spec.seed:x}-{i:05d}",
            )
        )
    return trace


# -- chaos plumbing (one logged line reproduces the whole run) -------------
def chaos_env(spec: LoadSpec) -> Dict[str, str]:
    """The env vars that arm this spec's fault plans — export them
    BEFORE ``ray_tpu_torch.init`` so replica processes inherit the plans."""
    env: Dict[str, str] = {}
    if spec.chaos_master_seed:
        env["RAY_TPU_testing_chaos_seed"] = str(int(spec.chaos_master_seed))
    for knob, value in (
        ("testing_rpc_chaos", spec.rpc_chaos),
        ("testing_pull_chaos", spec.pull_chaos),
        ("testing_replica_chaos", spec.replica_chaos),
    ):
        if value:
            env["RAY_TPU_" + knob] = value
    return env


def repro_line(spec: LoadSpec) -> str:
    """ONE line that replays the run: chaos env + the trace seed."""
    parts = [f"{k}={v}" for k, v in sorted(chaos_env(spec).items())]
    parts.append(f"LOADGEN_SEED={spec.seed}")
    return " ".join(parts)


# -- replay ----------------------------------------------------------------
@dataclass
class HarnessRun:
    spec: LoadSpec
    records: List[Dict[str, Any]]
    itl_gaps: List[float]
    started_wall: float
    duration_s: float
    #: (t_rel_s, serve.status() dict) samples when a status_fn was given
    samples: List[Any] = field(default_factory=list)


def run_trace(
    trace: Sequence[TraceRequest],
    *,
    spec: Optional[LoadSpec] = None,
    addresses: Optional[Sequence[str]] = None,
    stream_fn: Optional[Callable[[TraceRequest], Iterable[Any]]] = None,
    time_scale: float = 1.0,
    max_workers: int = 32,
    timeout_s: float = 30.0,
    status_fn: Optional[Callable[[], Any]] = None,
    status_period_s: float = 0.5,
) -> HarnessRun:
    """Replay a built trace against the serving stack: each request
    fires at ``t_s * time_scale`` after run start — through the tenant's
    rendezvous-hashed ingress door (``addresses``) or an injected
    ``stream_fn`` (unit tests). Client-side TTFT/ITL/e2e are measured
    per request; an optional ``status_fn`` (e.g. ``serve.status``) is
    sampled on a timer for target-timeline/autoscaler-lag scoring."""
    if addresses is None and stream_fn is None:
        raise ValueError("run_trace needs addresses or a stream_fn")
    records: List[Optional[Dict[str, Any]]] = [None] * len(trace)
    gaps: List[float] = []
    samples: List[Any] = []
    lock = threading.Lock()
    start = time.monotonic()
    started_wall = time.time()
    done = threading.Event()

    def _sample_loop() -> None:
        while not done.is_set():
            try:
                samples.append((time.monotonic() - start, status_fn()))
            except Exception:  # noqa: BLE001 — status poll must not kill the run
                pass
            done.wait(status_period_s)

    def _one(req: TraceRequest) -> None:
        rec: Dict[str, Any] = {
            "request_id": req.request_id,
            "tenant": req.tenant,
            "tenant_class": req.tenant_class,
            "t_s": req.t_s,
            "prompt_tokens": len(req.prompt),
            "max_new_tokens": req.max_new_tokens,
        }
        delay = start + req.t_s * time_scale - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        sent = time.monotonic()
        rec["sent_at_s"] = sent - start
        try:
            if stream_fn is not None:
                it = iter(stream_fn(req))
            else:
                addr = pick_ingress(req.tenant, addresses)
                it = http_stream(
                    addr,
                    {
                        "prompt": req.prompt,
                        "max_new_tokens": req.max_new_tokens,
                        "request_id": req.request_id,
                    },
                    tenant=req.tenant,
                    timeout_s=timeout_s,
                )
            ttft: Optional[float] = None
            itl_max = 0.0
            last = sent
            n = 0
            for _tok in it:
                now = time.monotonic()
                if ttft is None:
                    ttft = now - sent
                else:
                    gap = now - last
                    itl_max = max(itl_max, gap)
                    with lock:
                        gaps.append(gap)
                last = now
                n += 1
            rec.update(
                outcome="ok",
                ttft_s=ttft,
                itl_max_s=itl_max,
                n_tokens=n,
                e2e_s=time.monotonic() - sent,
            )
        except IngressShedError as e:
            rec.update(outcome="shed", shed_reason=e.reason, retry_after_s=e.retry_after)
        except Exception as e:  # noqa: BLE001 — a failed request is a data point
            rec.update(outcome="error", error=repr(e))
        records[req.index] = rec

    sampler = None
    if status_fn is not None:
        sampler = threading.Thread(target=_sample_loop, daemon=True)
        sampler.start()
    try:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            list(pool.map(_one, trace))
    finally:
        done.set()
        if sampler is not None:
            sampler.join(timeout=2.0)
    return HarnessRun(
        spec=spec or LoadSpec(),
        records=[r for r in records if r is not None],
        itl_gaps=gaps,
        started_wall=started_wall,
        duration_s=time.monotonic() - start,
        samples=samples,
    )


# -- scoring ---------------------------------------------------------------
def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def attribute_misses(
    records: Sequence[Dict[str, Any]],
    report: Optional[Dict[str, Any]],
    ttft_slo_s: float,
) -> Dict[str, Dict[str, Any]]:
    """request_id -> {outcome, ttft_s, stage, flags} for every SLO miss
    (TTFT over budget, or an outright error), joined against the flight
    recorder's per-request slowest-stage breakdown. ``"untracked"``
    means the recorder's ring had already evicted the request — raise
    ``slo_flight_recorder_slots`` for gated runs that must attribute
    every miss."""
    flights = {
        str(f.get("request_id")): f
        for f in (report or {}).get("flight_recorder") or []
    }
    out: Dict[str, Dict[str, Any]] = {}
    for r in records:
        missed = r.get("outcome") == "error" or (
            r.get("outcome") == "ok"
            and float(r.get("ttft_s") or 0.0) > ttft_slo_s
        )
        if not missed:
            continue
        f = flights.get(str(r["request_id"])) or {}
        out[str(r["request_id"])] = {
            "outcome": r.get("outcome"),
            "ttft_s": r.get("ttft_s"),
            "stage": f.get("slowest_stage") or "untracked",
            "flags": f.get("flags") or [],
        }
    return out


def score(
    run: HarnessRun,
    *,
    ttft_slo_s: float,
    itl_slo_s: Optional[float] = None,
    report: Optional[Dict[str, Any]] = None,
    status: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """SLO attainment for one run. Attainment counts errors as misses
    (a dead request never met its budget) and excludes shed requests
    (the door's explicit no — rate-limited/overloaded tenants are
    accounted separately, and a shed well-behaved tenant shows up in
    the ``by_class`` shed counts, not as silent forgiveness)."""
    ok = [r for r in run.records if r.get("outcome") == "ok"]
    shed = [r for r in run.records if r.get("outcome") == "shed"]
    errors = [r for r in run.records if r.get("outcome") == "error"]
    ttfts = sorted(float(r["ttft_s"]) for r in ok if r.get("ttft_s") is not None)
    e2es = sorted(float(r["e2e_s"]) for r in ok if r.get("e2e_s") is not None)
    gaps = sorted(run.itl_gaps)
    served = len(ok) + len(errors)
    attained = sum(
        1
        for r in ok
        if r.get("ttft_s") is not None and float(r["ttft_s"]) <= ttft_slo_s
    )
    out: Dict[str, Any] = {
        "requests": len(run.records),
        "ok": len(ok),
        "shed": len(shed),
        "errors": len(errors),
        "duration_s": round(run.duration_s, 3),
        "ttft": {
            "p50": _pct(ttfts, 0.50),
            "p99": _pct(ttfts, 0.99),
            "p999": _pct(ttfts, 0.999),
        },
        "itl": {
            "p50": _pct(gaps, 0.50),
            "p99": _pct(gaps, 0.99),
            "p999": _pct(gaps, 0.999),
        },
        "e2e_p99": _pct(e2es, 0.99),
        "ttft_slo_s": ttft_slo_s,
        "ttft_attainment": attained / served if served else 1.0,
        "by_class": {},
        "repro": repro_line(run.spec),
    }
    if itl_slo_s is not None:
        out["itl_slo_s"] = itl_slo_s
        out["itl_attainment"] = (
            sum(1 for g in gaps if g <= itl_slo_s) / len(gaps) if gaps else 1.0
        )
    for cls in _CLASSES:
        crecs = [r for r in run.records if r.get("tenant_class") == cls]
        if not crecs:
            continue
        cok = [r for r in crecs if r.get("outcome") == "ok"]
        cserved = len(cok) + sum(1 for r in crecs if r.get("outcome") == "error")
        cattained = sum(
            1
            for r in cok
            if r.get("ttft_s") is not None and float(r["ttft_s"]) <= ttft_slo_s
        )
        out["by_class"][cls] = {
            "requests": len(crecs),
            "shed": sum(1 for r in crecs if r.get("outcome") == "shed"),
            "errors": sum(1 for r in crecs if r.get("outcome") == "error"),
            "ttft_attainment": cattained / cserved if cserved else 1.0,
        }
    if report is not None:
        deps = report.get("deployments") or {}
        for name, block in deps.items():
            if "goodput_fraction" in block:
                out.setdefault("goodput_fraction", {})[name] = block[
                    "goodput_fraction"
                ]
        out["miss_attribution"] = attribute_misses(
            run.records, report, ttft_slo_s
        )
    if status is not None:
        # autoscaler lag: run start -> the first APPLIED scale-out, from
        # the controller's wall-clock last_scale stamp
        lags = [
            float(blk["last_scale"]["ts"]) - run.started_wall
            for blk in status.values()
            if blk.get("last_scale")
            and blk["last_scale"].get("to", 0) > blk["last_scale"].get("from", 0)
            and float(blk["last_scale"].get("ts", 0.0)) >= run.started_wall
        ]
        out["autoscaler_lag_s"] = round(min(lags), 3) if lags else None
    return out


__all__ = [
    "HarnessRun",
    "LoadSpec",
    "TraceRequest",
    "attribute_misses",
    "build_trace",
    "chaos_env",
    "repro_line",
    "run_trace",
    "score",
]
