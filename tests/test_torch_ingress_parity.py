"""The port's front door (``serve/ingress.py``, ``serve/loadgen.py``) held
against the JAX package's on the same inputs.

Pure policy: the token bucket under injected clocks, the shed verdict and
its ITL-scaled threshold for every priority class, the tenant-to-door
rendezvous hash, ``loadgen.build_trace`` on three specs (one of them the
trace ``chip_smoke.py`` phase ``ingress`` replays at 7B) and
``loadgen.score`` on one synthetic run decide alike in both packages, on
inputs drawn from seeded numpy streams.

The door itself: a port ``llm_deployment`` bound with the JAX package's
tiny f32 params (carried by ``params_from_jax``) behind a port
``ingress_deployment`` streams, through ``http_stream``, greedy and seeded
(temperature 0.8) requests token for token as the JAX package's
``InferenceEngine`` streams them in-process, with the engine config of
``tests/test_ingress.py``. These are the requests whose margins
``tests/test_torch_paged.py::test_engine_matches_jax_engine`` shows safe
across the frameworks in f32.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.inference.engine import EngineConfig as JaxEngineConfig
from ray_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from ray_tpu.models import llama as jl
from ray_tpu.serve import ingress as jing
from ray_tpu.serve import loadgen as jlg
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.inference import EngineConfig
from ray_tpu_torch.models.llama import LlamaConfig, init_params, params_from_jax
from ray_tpu_torch.serve import ingress as ting
from ray_tpu_torch.serve import loadgen as tlg
from ray_tpu_torch.util.reaper import find_runtime_pids

torch.set_num_threads(1)

#: the engine config of ``tests/test_ingress.py``
_EC = dict(
    num_blocks=64, block_size=8, prefill_buckets=(8, 32),
    decode_buckets=(1, 8), max_decode_batch=8, max_new_tokens_default=8,
)


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, as a module (its ``main`` is
    guarded, and it imports only the standard library at its top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the trace ``chip_smoke.py`` phase ``ingress`` (b) replays at 7B
CHIP_SPEC = _chip_smoke().INGRESS_SPEC

#: the trace of ``tests/test_ingress.py::test_loadgen_trace_replays_through_ingress``
SUITE_SPEC = dict(
    seed=20260806, duration_s=2.0, base_rate_rps=5.0, burst_factor=2.0,
    n_tenants=3, prompt_min=3, prompt_max=12, prefix_len=4,
    output_min=2, output_max=4,
)


# ---------------------------------------------------------------------------
# pure policy


@pytest.mark.parametrize("seed", range(6))
def test_token_bucket_decides_alike(seed):
    """The same takes at the same injected clock give the same refusals,
    the same quoted waits and the same levels, bit for bit."""
    rs = np.random.RandomState(seed)
    rate, burst = float(rs.uniform(0.5, 50.0)), float(rs.uniform(1.0, 400.0))
    jb, tb = jing.TokenBucket(rate, burst), ting.TokenBucket(rate, burst)
    now = 1000.0
    jb.stamp = tb.stamp = now
    waits = 0
    for _ in range(200):
        now += float(rs.exponential(0.3)) if rs.rand() < 0.8 else 0.0
        cost = float(rs.choice([rs.randint(1, 64), rs.uniform(0, 2 * burst)]))
        jw, tw = jb.try_take(cost, now=now), tb.try_take(cost, now=now)
        assert tw == jw and tb.level == jb.level and tb.stamp == jb.stamp
        waits += jw > 0
    assert 0 < waits < 200  # both the take and the refusal were reached


def _pressure(rs):
    p = {
        "reporting": int(rs.randint(0, 5)),
        "outstanding_tokens": float(rs.choice([0.0, rs.uniform(0, 20000)])),
        "queue_depth": int(rs.randint(0, 300)),
        "max_queue_depth": int(rs.choice([0, 64, 256])),
    }
    if rs.rand() < 0.5:
        p["itl_p99_s"] = float(rs.choice([0.0, rs.uniform(0.001, 2.0)]))
    return p


def _ingress_cfgs(pkg, rs):
    return [
        pkg.IngressConfig(
            shed_outstanding_per_replica=float(rs.choice([0.0, rs.uniform(50, 5000)])),
            shed_queue_fraction=float(rs.uniform(0.0, 1.2)),
            shed_itl_target_s=(None if rs.rand() < 0.4 else float(rs.uniform(0.01, 1.0))),
        )
        for _ in range(8)
    ]


def test_shed_verdict_and_threshold_decide_alike():
    """Over seeded pressure dicts, configs and every class: the same
    verdict (admit, ``load`` or ``queue_pressure``) and the same
    ITL-scaled watermark."""
    rs = np.random.RandomState(15)
    seed = rs.randint(1 << 30)
    jcfgs = _ingress_cfgs(jing, np.random.RandomState(seed))
    tcfgs = _ingress_cfgs(ting, np.random.RandomState(seed))
    assert [dataclasses.asdict(c) for c in jcfgs] == [dataclasses.asdict(c) for c in tcfgs]
    assert ting.CLASS_PRIORITY == jing.CLASS_PRIORITY
    verdicts = set()
    for _ in range(300):
        p = _pressure(rs)
        for jc, tc in zip(jcfgs, tcfgs):
            itl = float(p.get("itl_p99_s") or 0.0)
            assert ting.effective_shed_threshold(
                tc.shed_outstanding_per_replica, tc.shed_itl_target_s, itl
            ) == jing.effective_shed_threshold(
                jc.shed_outstanding_per_replica, jc.shed_itl_target_s, itl
            )
            for prio in sorted(jing.CLASS_PRIORITY.values()):
                v = ting.shed_verdict(dict(p), prio, tc)
                assert v == jing.shed_verdict(dict(p), prio, jc), (p, prio, jc)
                verdicts.add(v)
    assert verdicts == {None, "load", "queue_pressure"}


def test_pick_ingress_decides_alike():
    rs = np.random.RandomState(7)
    for _ in range(40):
        addrs = [f"10.0.{rs.randint(256)}.{rs.randint(256)}:{rs.randint(1024, 65535)}"
                 for _ in range(rs.randint(1, 9))]
        for _ in range(16):
            tenant = "".join(chr(97 + c) for c in rs.randint(0, 26, size=rs.randint(1, 12)))
            assert ting.pick_ingress(tenant, addrs) == jing.pick_ingress(tenant, addrs)
    for pkg in (jing, ting):
        with pytest.raises(ValueError):
            pkg.pick_ingress("t", [])


@pytest.mark.parametrize("spec", [dict(seed=3), SUITE_SPEC, CHIP_SPEC],
                         ids=["default", "suite", "chip"])
def test_build_trace_decides_alike(spec):
    """Every arrival, tenant, class, prompt, ``max_new_tokens`` and
    ``request_id`` equal."""
    jt = jlg.build_trace(jlg.LoadSpec(**spec))
    tt = tlg.build_trace(tlg.LoadSpec(**spec))
    assert jt and [dataclasses.asdict(r) for r in tt] == [dataclasses.asdict(r) for r in jt]
    assert tlg.repro_line(tlg.LoadSpec(**spec)) == jlg.repro_line(jlg.LoadSpec(**spec))


def _synthetic_run(pkg, rs):
    """A run of 60 records (ok, shed, error, across the three classes), its
    ITL gaps, a report whose flight recorder knows some of the misses, and
    a status with one scale-out inside the run."""
    spec = pkg.LoadSpec(seed=11, rpc_chaos="push_batch:0.05", chaos_master_seed=99)
    records = []
    for i in range(60):
        rec = {"request_id": f"r{i}", "tenant": f"t{i % 5}",
               "tenant_class": ("interactive", "standard", "batch")[i % 3], "t_s": i * 0.1}
        u = rs.rand()
        if u < 0.7:
            rec.update(outcome="ok", ttft_s=float(rs.exponential(0.8)),
                       e2e_s=float(rs.uniform(1, 5)), n_tokens=int(rs.randint(1, 64)))
        elif u < 0.9:
            rec.update(outcome="shed", shed_reason=str(rs.choice(["rate_limit", "load"])))
        else:
            rec.update(outcome="error", error="boom")
        records.append(rec)
    gaps = [float(g) for g in rs.exponential(0.2, size=300)]
    report = {
        "deployments": {"llm": {"goodput_fraction": 0.75}, "ing": {}},
        "flight_recorder": [{"request_id": f"r{i}", "slowest_stage": "prefill",
                             "flags": ["slow_ttft"]} for i in range(0, 60, 4)],
    }
    status = {"llm": {"last_scale": {"from": 1, "to": 2, "ts": 1000.5}},
              "ing": {"last_scale": {"from": 2, "to": 1, "ts": 1000.7}}}
    run = pkg.HarnessRun(spec=spec, records=records, itl_gaps=gaps,
                         started_wall=1000.0, duration_s=6.1234)
    return run, report, status


def test_score_decides_alike():
    jrun, jrep, jst = _synthetic_run(jlg, np.random.RandomState(5))
    trun, trep, tst = _synthetic_run(tlg, np.random.RandomState(5))
    for ttft_slo, itl_slo in ((1.0, 0.3), (2.0, None), (0.05, 0.01)):
        js = jlg.score(jrun, ttft_slo_s=ttft_slo, itl_slo_s=itl_slo, report=jrep, status=jst)
        ts = tlg.score(trun, ttft_slo_s=ttft_slo, itl_slo_s=itl_slo, report=trep, status=tst)
        assert ts == js
    assert js["errors"] and js["shed"] and js["miss_attribution"]
    assert js["autoscaler_lag_s"] == 0.5
    assert tlg.attribute_misses(trun.records, trep, 1.0) == jlg.attribute_misses(
        jrun.records, jrep, 1.0)


# ---------------------------------------------------------------------------
# the door on the same weights


@pytest.fixture(scope="module")
def door():
    """A port deployment bound with the JAX package's tiny f32 params, a
    port door in front of it (on one module-scoped cluster, one OpenMP
    thread per process), and the JAX params."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = init_params(tcfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        c = Cluster(num_cpus=4)
        controller = f"127.0.0.1:{c.controller_port}"
        try:
            rt.init(address=c.address)
            serve.run(serve.llm_deployment(
                tcfg, engine=EngineConfig(**_EC), name="llm", route_prefix="/llm",
                ray_actor_options={"num_cpus": 0.25},
            ).bind(params=model, device="cpu"))
            serve.run(ting.ingress_deployment(
                "llm", ting.IngressConfig(
                    target="llm", tenants={"vip": ting.TenantPolicy(tenant_class="interactive")}),
                name="ing").bind(), name="ing")
            yield jcfg, jp, ting.ingress_addresses("ing")[0]
        finally:
            try:
                serve.shutdown()
            finally:
                rt.shutdown()
                c.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(controller_addr=controller) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert find_runtime_pids(controller_addr=controller) == []


def _door_requests(vocab):
    """Greedy and seeded requests: those of ``test_engine_matches_jax_engine``
    and the reference suite's own greedy request."""
    rs = np.random.RandomState(21)
    rep = [1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5]
    long_ = [int(x) for x in rs.randint(1, vocab, size=40)]
    sampled = [int(x) for x in rs.randint(1, vocab, size=9)]
    seeded = {"temperature": 0.8, "seed": 5}
    return [
        {"prompt": [3, 7, 11, 5], "max_new_tokens": 6},
        {"prompt": rep, "max_new_tokens": 10},
        {"prompt": long_, "max_new_tokens": 10},
        {"prompt": sampled, "max_new_tokens": 10, **seeded},
        {"prompt": long_[:16], "max_new_tokens": 10},
        {"prompt": sampled, "max_new_tokens": 10, "temperature": 0.8, "seed": 6},
    ]


def test_door_streams_match_jax_engine(door):
    jcfg, jp, addr = door
    requests = _door_requests(jcfg.vocab_size)
    ref = JaxInferenceEngine(jcfg, jp, JaxEngineConfig(**_EC)).start()
    try:
        expected = [
            list(ref.generate(r["prompt"], max_new_tokens=r["max_new_tokens"],
                              temperature=r.get("temperature", 0.0), seed=r.get("seed")))
            for r in requests
        ]
    finally:
        ref.stop()
    served = [list(ting.http_stream(addr, r, tenant="vip")) for r in requests]
    assert [len(s) for s in expected] == [r["max_new_tokens"] for r in requests]
    assert served == expected
    assert expected[3] != expected[5]  # the seed reaches the sampler
