"""The port's LLM deployment behind its serve layer, on the port's own
cluster, on the CPU: ports of the five cases of ``tests/test_serve_llm.py``
and of the two chaos E2Es of ``tests/test_stream_resume.py``, the node
drain listener, and the slice against the JAX package.

Replicas serve on the CPU through ``bind(device="cpu")``, with ``params=``
too (on the card a replica takes a GPU lease and serves on ``cuda``). The head node
declares ``{"GPU": 1}``, since the box has no card. The chaos E2Es arm the
reference's seeded kill plan in the environment of an added node, so that
every replica placed there, controller replacements included, consults it,
while the rest of the cluster stays clean. Every test that deploys deletes
its deployment in a ``finally``.

Against the JAX package: a deployment bound with the JAX-initialised tiny
f32 params (carried by ``params_from_jax``) gives the token streams of the
JAX package's in-process ``LLMServer``, on the requests whose margins
``tests/test_torch_paged.py::test_engine_matches_jax_engine`` shows safe
across the frameworks; within the port every comparison is byte-exact.
"""

import os
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.inference.engine import EngineConfig as JaxEngineConfig
from ray_tpu.inference.serve_llm import LLMServer as JaxLLMServer
from ray_tpu.models import llama as jl
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.inference import EngineConfig, InferenceEngine, LLMServer
from ray_tpu_torch.inference.serve_llm import llm_deployment
from ray_tpu_torch.models.llama import LlamaConfig, init_params, params_from_jax
from ray_tpu_torch.serve.replica import Replica
from ray_tpu_torch.util import state
from ray_tpu_torch.util.chaos import ReplicaFaultPlan
from ray_tpu_torch.util.reaper import find_runtime_pids

torch.set_num_threads(1)

#: the kill plan of the reference's chaos cluster
CHAOS_SPEC, CHAOS_SEED = "kill_mid_decode:1.0:6", 20260804


@pytest.fixture(scope="module")
def cluster():
    # one torch thread in each of the cluster's processes, as in this one:
    # the replicas run beside the rest of the suite
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        c = Cluster(head_resources={"GPU": 1}, num_cpus=4)
        controller = f"127.0.0.1:{c.controller_port}"
        try:
            rt.init(address=c.address)
            yield c
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


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def llm_handle(cluster, cfg):
    ec = EngineConfig(
        num_blocks=64, block_size=8, prefill_buckets=(8, 16, 32),
        decode_buckets=(1, 2, 4, 8), max_decode_batch=8,
        max_new_tokens_default=8,
    )
    dep = serve.llm_deployment(
        cfg, engine=ec, num_replicas=1, ray_actor_options={"num_cpus": 0.5}
    )
    try:
        yield serve.run(dep.bind(device="cpu"))
    finally:
        serve.delete("llm")


def _controller():
    return rt.get_actor("__serve_controller__")


def _stats(replica):
    return rt.get(replica.handle_request.remote("engine_stats", [], {}, ""), timeout=60)


def _live_streams(handle, requests, started):
    """One thread per request streaming through ``handle``; each waits on
    ``started`` once its first token is in. Returns (threads, results,
    errors)."""
    results, errors = {}, {}

    def consume(i, req):
        try:
            it = iter(handle.stream(req, _method="generate", _timeout=120))
            first = next(it)
            started.wait()
            results[i] = [first] + list(it)
        except Exception as e:  # noqa: BLE001
            errors[i] = e
            try:
                started.wait()
            except Exception:
                pass

    threads = [threading.Thread(target=consume, args=(i, r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    return threads, results, errors


# ---------------------------------------------------------------------------
# ports of tests/test_serve_llm.py


def test_concurrent_streaming_with_continuous_batching(llm_handle):
    n = 8
    results, errors = {}, {}

    def consume(i):
        try:
            results[i] = list(llm_handle.stream(
                {"prompt": [1 + i, 2, 3, 4 + i], "max_new_tokens": 12},
                _method="generate", _timeout=120,
            ))
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(results) == n
    assert all(len(v) == 12 for v in results.values())
    # same prompt twice -> same greedy stream
    again = list(llm_handle.stream(
        {"prompt": [1, 2, 3, 4], "max_new_tokens": 12}, _method="generate", _timeout=120,
    ))
    assert again == results[0]

    stats = rt.get(llm_handle.method("engine_stats")(), timeout=60)
    sched = stats["scheduler"]
    # continuous batching observably active
    assert sched["max_decode_batch_seen"] > 1, sched
    assert sched["steps_with_prefill_and_decode"] > 0, sched
    assert stats["recompiles_after_warmup"] == 0
    # prefill + decode buckets + the COW block-copy program
    assert stats["compile_count"] == 3 + 4 + 1
    assert stats["blocks"]["used_blocks"] == 0


def test_metrics_visible_on_metrics_endpoint(llm_handle):
    addr = rt.get(llm_handle.method("metrics_address")(), timeout=60)
    assert addr, "replica did not start a metrics endpoint"
    body = urllib.request.urlopen(f"http://{addr}/metrics", timeout=10).read().decode()
    for needle in (
        "raytpu_llm_ttft_seconds",
        "raytpu_llm_tokens_per_s",
        "raytpu_llm_kv_cache_utilization",
        "raytpu_llm_queue_depth",
        "raytpu_llm_tokens_generated_total",
    ):
        assert needle in body, f"{needle} missing from /metrics"


def test_replica_testing_device_info(llm_handle):
    """Read inside the replica: a CPU replica, spawned without a GPU lease
    (``CUDA_VISIBLE_DEVICES=""``), with no card memory and no flash
    launch (the serving path has none)."""
    info = rt.get(llm_handle.method("testing_device_info")(), timeout=60)
    assert info["device"] == "cpu" and info["cuda_visible_devices"] == ""
    assert info["device_name"] is None and info["max_memory_allocated_bytes"] is None
    assert info["pid"] != os.getpid() and info["init_s"] > 0
    assert info["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_nonstreaming_call_and_deadline_budget(llm_handle):
    out = rt.get(llm_handle.remote({"prompt": [5, 6, 7], "max_new_tokens": 4}), timeout=120)
    assert len(out["tokens"]) == 4
    # an already-spent budget fails the generation at the replica
    with pytest.raises(Exception):
        with rt.deadline_scope(0.0):
            rt.get(llm_handle.remote({"prompt": [5, 6, 7], "max_new_tokens": 4}), timeout=30)


def test_drain_finishes_in_flight_streams_zero_errors(llm_handle):
    """Engine drain mid-decode: in-flight streams complete cleanly."""
    n = 4
    started = threading.Barrier(n + 1, timeout=60)
    threads, results, errors = _live_streams(
        llm_handle, [{"prompt": [2 + i, 3, 5], "max_new_tokens": 40} for i in range(n)], started)
    started.wait()  # every stream has produced >= 1 token
    rt.get(llm_handle.method("begin_drain")(30.0), timeout=60)
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert all(len(v) == 40 for v in results.values()), {k: len(v) for k, v in results.items()}
    stats = rt.get(llm_handle.method("engine_stats")(), timeout=60)
    assert stats["draining"] is True
    assert stats["scheduler"]["running"] == 0
    assert stats["blocks"]["used_blocks"] == 0


def test_multi_replica_affinity_routing_and_replica_death(cluster, cfg):
    """Two replicas with cache-affinity routing pin same-prefix streams to
    the prefix-warm replica; killing the other mid-stream leaves every
    live stream to finish with no error, and the controller replaces it."""
    from ray_tpu_torch.observability.rpc_metrics import ROUTER_AFFINITY_HITS

    ec = EngineConfig(
        num_blocks=64, block_size=8, prefill_buckets=(8, 32),
        decode_buckets=(1, 4), max_decode_batch=4, max_new_tokens_default=8,
        warmup=False,
    )
    dep = serve.llm_deployment(
        cfg, engine=ec, name="llm2", num_replicas=2,
        route_prefix="/llm2", ray_actor_options={"num_cpus": 0.25},
    )
    old_weight = GLOBAL_CONFIG.serve_affinity_weight
    # pin hard: affinity must beat the optimistic load bumps
    GLOBAL_CONFIG.serve_affinity_weight = 1e6
    try:
        handle = serve.run(dep.bind(device="cpu"))
        ctrl = _controller()
        rt.get(ctrl.wait_status.remote("llm2", min_replicas=2, timeout_s=60), timeout=90)
        prompt = [11, 3, 7, 5, 2, 9, 8, 6] * 3  # 24 tokens = 3 full blocks
        warm = list(handle.stream(
            {"prompt": prompt + [42], "max_new_tokens": 4}, _method="generate", _timeout=120,
        ))
        assert len(warm) == 4
        deadline = time.monotonic() + 20
        warm_replica = cold_replica = None
        while time.monotonic() < deadline:
            replicas = rt.get(ctrl.get_replicas.remote("llm2"), timeout=30)
            admitted = [_stats(r)["scheduler"]["total_admitted"] for r in replicas]
            hot = [r for r, a in zip(replicas, admitted) if a > 0]
            cold = [r for r, a in zip(replicas, admitted) if a == 0]
            if len(replicas) == 2 and len(hot) == 1 and len(cold) == 1:
                warm_replica, cold_replica = hot[0], cold[0]
                break
            time.sleep(0.25)
        assert warm_replica is not None, "could not identify the warm replica"
        time.sleep(3 * GLOBAL_CONFIG.serve_replica_stats_period_s)

        hits_before = ROUTER_AFFINITY_HITS._values.get(("llm2",), 0.0)
        n = 4
        started = threading.Barrier(n + 1, timeout=60)
        threads, results, errors = _live_streams(
            handle, [{"prompt": prompt + [60 + i], "max_new_tokens": 30} for i in range(n)],
            started)
        started.wait()  # every stream produced >= 1 token
        rt.kill(cold_replica)  # the replica the affinity router did NOT pick
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(len(v) == 30 for v in results.values()), {k: len(v) for k, v in results.items()}
        assert ROUTER_AFFINITY_HITS._values.get(("llm2",), 0.0) > hits_before
        warm_stats = _stats(warm_replica)
        assert warm_stats["prefix_cache"]["hits_total"] >= n
        assert warm_stats["prefix_cache"]["tokens_saved_total"] >= n * 24
        st = rt.get(ctrl.wait_status.remote("llm2", min_replicas=2, timeout_s=90), timeout=120)
        assert st["replicas"] == 2, st
        again = list(handle.stream(
            {"prompt": prompt + [42], "max_new_tokens": 4}, _method="generate", _timeout=120,
        ))
        assert again == warm
    finally:
        GLOBAL_CONFIG.serve_affinity_weight = old_weight
        serve.delete("llm2")


# ---------------------------------------------------------------------------
# the node drain listener, the deployment's surface, and the JAX package


def _wait_for_resource(name, timeout=60.0):
    deadline = time.monotonic() + timeout
    while rt.cluster_resources().get(name, 0) <= 0:
        assert time.monotonic() < deadline, f"no node offers {name!r}"
        time.sleep(0.1)


def test_node_drain_drains_the_replica_engine(cluster, cfg):
    """A preemption warning on a replica's node (``drain_node``) reaches
    the engine's node drain listener: the replica stops admitting, and the
    stream it is serving still finishes (port of the listener half of
    ``tests/test_drain.py::test_serve_drain_zero_failed_requests``)."""
    node = cluster.add_node(num_cpus=2, resources={"drainme": 1})
    _wait_for_resource("drainme")
    ec = EngineConfig(num_blocks=32, block_size=8, prefill_buckets=(8,), decode_buckets=(1,),
                      max_decode_batch=1, warmup=False)
    dep = llm_deployment(cfg, engine=ec, name="llmdrain", route_prefix="/llmdrain",
                         ray_actor_options={"num_cpus": 0.25, "resources": {"drainme": 1}})
    try:
        handle = serve.run(dep.bind(device="cpu"))
        (replica,) = rt.get(_controller().get_replicas.remote("llmdrain"), timeout=30)
        aid = replica._actor_id.hex()
        nid = next(a["node_id"] for a in state.list_actors() if a["actor_id"] == aid)
        assert nid == node.node_id_hex != rt.get_runtime_context().get_node_id()
        assert _stats(replica)["draining"] is False
        # a stream held open by a one-off 4 s stall keeps the replica busy,
        # so serve's drain handoff waits for it instead of killing at once
        rt.get(replica.handle_request.remote(
            "testing_arm_replica_chaos", ["stall:1.0:4.0:1", 3], {}, ""), timeout=60)
        started = threading.Barrier(2, timeout=60)
        threads, results, errors = _live_streams(
            handle, [{"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 8}], started)
        deadline = time.monotonic() + 30
        while rt.get(replica.stats.remote(), timeout=30)["ongoing"] == 0:
            assert time.monotonic() < deadline, "the stream never reached the replica"
            time.sleep(0.05)
        assert rt.drain_node(nid, "test: preemption warning")
        deadline = time.monotonic() + 10
        while not _stats(replica)["draining"]:
            assert time.monotonic() < deadline, "the node event never drained the engine"
            time.sleep(0.05)
        started.wait()
        threads[0].join(timeout=120)
        assert not errors, errors
        assert len(results[0]) == 8
    finally:
        serve.delete("llmdrain")
        cluster.remove_node(node)


def test_deployment_surface(cluster, cfg):
    """``serve.llm_deployment`` is the port's; the tier and disaggregated
    pools raise naming the ROADMAP item, and the split pools' options are
    not taken; a replica with no device named serves on ``cuda``, whether
    it builds its params or is given host ones, and raises without a card,
    with no CPU fallback."""
    assert serve.llm_deployment is llm_deployment and serve.LLMServer is LLMServer
    for kw in ({"kv_tier": True}, {"disaggregated": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A: item 4"):
            llm_deployment(cfg, **kw)
    with pytest.raises(TypeError, match="prefill_replicas"):
        llm_deployment(cfg, prefill_replicas=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the replica would build on it")
    replicas = [
        Replica.options(num_cpus=0.25).remote(
            LLMServer, [cfg, EngineConfig(warmup=False)], kwargs, name)
        for kwargs, name in (({"seed": 0}, "nogpu"),
                             ({"params": init_params(cfg, 0, device="cpu")}, "nogpu_params"))
    ]
    for replica in replicas:
        with pytest.raises(Exception, match="no CUDA device"):
            rt.get(replica.health.remote(), timeout=120)


def _jax_streams_requests(vocab):
    """The requests of ``test_engine_matches_jax_engine`` (one at a time)."""
    rs = np.random.RandomState(21)
    rep = [1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5]
    long_ = [int(x) for x in rs.randint(1, vocab, size=40)]
    sampled = [int(x) for x in rs.randint(1, vocab, size=9)]
    seeded = {"temperature": 0.8, "seed": 5}
    return [
        {"prompt": rep}, {"prompt": long_}, {"prompt": sampled, **seeded},
        {"prompt": long_[:16]}, {"prompt": rep + [9, 9]}, {"prompt": sampled, **seeded},
    ]


def test_deployment_matches_jax_server(cluster):
    """The slice against the JAX package: a deployment bound with the
    JAX-initialised params gives, through the handle, the JAX package's
    in-process ``LLMServer`` streams token for token, greedy and seeded at
    0.8, and the port's in-process ``LLMServer`` streams byte for byte."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = init_params(tcfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    engine = dict(num_blocks=64, block_size=8, prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
                  max_decode_batch=4, speculative_k=4, speculative_adaptive=False,
                  prefix_cache_enabled=True, warmup=False)
    requests = [{**r, "max_new_tokens": 10} for r in _jax_streams_requests(tcfg.vocab_size)]
    ref = JaxLLMServer(jcfg, JaxEngineConfig(**engine), params=jp, export_metrics=False)
    ours = LLMServer(tcfg, EngineConfig(**engine), params=model, export_metrics=False,
                     device="cpu")
    try:
        expected = [[t for chunk in ref.generate(r) for t in chunk] for r in requests]
        local = [[t for chunk in ours.generate(r) for t in chunk] for r in requests]
    finally:
        ref.engine.stop()
        ours.engine.stop()
    dep = llm_deployment(tcfg, engine=EngineConfig(**engine), name="llmjax",
                         route_prefix="/llmjax", ray_actor_options={"num_cpus": 0.5})
    try:
        handle = serve.run(dep.bind(params=model, device="cpu"))
        served = [list(handle.stream(r, _method="generate", _timeout=120)) for r in requests]
        whole = rt.get(handle.remote(requests[2]), timeout=120)["tokens"]
    finally:
        serve.delete("llmjax")
    assert [len(s) for s in expected] == [10] * 6
    assert served == expected
    assert local == expected
    assert whole == expected[2] == expected[5]


# ---------------------------------------------------------------------------
# ports of the chaos E2Es of tests/test_stream_resume.py


@pytest.fixture
def chaos_node(cluster):
    """A node whose daemon, and so every worker it spawns (replicas and
    their replacements), carries the seeded kill plan in its environment;
    deployments reach it through the ``chaos`` resource. The test process's
    config read its environment at import, so its own engines stay clean."""
    os.environ["RAY_TPU_testing_replica_chaos"] = CHAOS_SPEC
    os.environ["RAY_TPU_testing_replica_chaos_seed"] = str(CHAOS_SEED)
    try:
        node = cluster.add_node(num_cpus=2, resources={"chaos": 8})
    finally:
        os.environ.pop("RAY_TPU_testing_replica_chaos", None)
        os.environ.pop("RAY_TPU_testing_replica_chaos_seed", None)
    assert GLOBAL_CONFIG.testing_replica_chaos == ""
    try:
        _wait_for_resource("chaos")
        yield node
    finally:
        cluster.remove_node(node)


CHAOS_REPLICA = {"num_cpus": 0.25, "resources": {"chaos": 1}}


@pytest.mark.chaos
def test_e2e_hot_replica_killed_mid_decode_byte_exact(cfg, params, chaos_node):
    """A seeded ReplicaFaultPlan SIGKILLs the affinity-hot replica
    mid-decode under 8 concurrent streams; every client receives the
    byte-exact token sequence of an undisturbed run, the resume and
    restart counters prove the deaths happened, the plan's schedule
    reproduces from its seed, and the SLO ledger books the replayed
    tokens as fault."""
    from ray_tpu_torch.observability import slo as _slo
    from ray_tpu_torch.observability.rpc_metrics import (
        STREAM_RESUME_REPLAY_TOKENS,
        STREAM_RESUMES,
    )

    ec = EngineConfig(
        num_blocks=64, block_size=8, prefill_buckets=(8, 32),
        decode_buckets=(1, 8), max_decode_batch=8, max_new_tokens_default=8,
        speculative_k=2,
    )
    shared = [11, 3, 7, 5, 2, 9, 8, 6] * 3  # 24 tokens = 3 full blocks
    n, max_new = 8, 12
    prompts = {i: shared + [60 + i] for i in range(n)}
    ref = InferenceEngine(cfg, params, ec).start()
    try:
        expected = {
            i: list(ref.generate(prompts[i], max_new_tokens=max_new,
                                 temperature=0.7, seed=100 + i))
            for i in range(n)
        }
    finally:
        ref.stop()
    old_weight = GLOBAL_CONFIG.serve_affinity_weight
    GLOBAL_CONFIG.serve_affinity_weight = 1e6  # pin streams to the warm replica
    try:
        dep = serve.llm_deployment(
            cfg, engine=ec, name="llmx", num_replicas=2,
            route_prefix="/llmx", ray_actor_options=CHAOS_REPLICA,
        )
        handle = serve.run(dep.bind(device="cpu"))
        ctrl = _controller()
        rt.get(ctrl.wait_status.remote("llmx", min_replicas=2, timeout_s=90), timeout=120)
        # warm ONE replica and let its gossip reach the router
        list(handle.stream(
            {"prompt": shared + [42], "max_new_tokens": 2}, _method="generate", _timeout=120,
        ))
        time.sleep(3 * GLOBAL_CONFIG.serve_replica_stats_period_s)

        resumes_before = STREAM_RESUMES._values.get(("llmx",), 0.0)
        replay_before = STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0)
        GLOBAL_CONFIG.trace_sample_rate = 1.0
        led_before_ids = {e.get("request_id") for e in _slo.flight_recorder().snapshot()}
        results, errors = {}, {}

        def consume(i):
            try:
                results[i] = list(handle.stream(
                    {"prompt": prompts[i], "max_new_tokens": max_new,
                     "temperature": 0.7, "seed": 100 + i, "request_id": f"slo{i}"},
                    _method="generate", _timeout=180,
                ))
            except Exception as e:  # noqa: BLE001
                errors[i] = e

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not errors, errors
        assert results == expected, {
            i: (results.get(i), expected[i]) for i in range(n) if results.get(i) != expected[i]
        }
        resumes = STREAM_RESUMES._values.get(("llmx",), 0.0) - resumes_before
        assert resumes > 0, "chaos plan never killed the hot replica"
        st = rt.get(ctrl.wait_status.remote("llmx", min_replicas=2, timeout_s=120), timeout=150)
        assert st["replicas"] == 2, st
        assert st["restarts"]["death"] >= 1, st
        p1, p2 = ReplicaFaultPlan(CHAOS_SPEC, CHAOS_SEED), ReplicaFaultPlan(CHAOS_SPEC, CHAOS_SEED)
        phases = ["prefill"] * 3 + ["decode"] * 20
        s1 = [p1.consult(p) for p in phases]
        assert s1 == [p2.consult(p) for p in phases]
        assert p1.injections == 1 and ("kill_mid_decode", 6.0) in s1

        # the SLO ledger on the same chaos run
        rep = serve.slo_report()
        dep_rep = rep["deployments"].get("llmx")
        assert dep_rep, list(rep["deployments"])
        for key in ("ttft_s", "itl_s", "e2e_s"):
            blk = dep_rep[key]
            assert blk["count"] > 0 and blk.get("p50") is not None, (key, blk)
            assert blk.get("p999") is not None, (key, blk)
        deadline_b = time.monotonic() + 20
        while time.monotonic() < deadline_b and not dep_rep.get("books_balanced"):
            time.sleep(0.5)
            rep = serve.slo_report()
            dep_rep = rep["deployments"]["llmx"]
        assert dep_rep["books_balanced"] is True, dep_rep["books"]
        assert dep_rep["books"], rep
        assert dep_rep["goodput_tokens"] > 0, dep_rep
        assert dep_rep["fault_tokens"].get("resume_replay", 0) > 0, dep_rep
        ours = [r for r in rep["flight_recorder"]
                if str(r["request_id"]).startswith("slo") and r["resumes"] > 0]
        assert ours, [r["request_id"] for r in rep["flight_recorder"][:10]]
        rec = ours[0]
        assert rec["stages"].get("router.failover", 0) > 0, rec
        assert rec["slowest_stage"], rec
        assert rec.get("trace_id"), rec
        trace_ids = {(e.get("args") or {}).get("trace_id") for e in rt.timeline()}
        assert rec["trace_id"] in trace_ids, rec["trace_id"]
        replay_delta = STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0) - replay_before
        led_new = [e for e in _slo.flight_recorder().snapshot()
                   if e.get("tier") == "router" and e.get("request_id") not in led_before_ids]
        assert replay_delta == sum(e["replayed_tokens"] for e in led_new), (
            replay_delta, [(e["request_id"], e["replayed_tokens"]) for e in led_new])
        assert replay_delta > 0
    finally:
        GLOBAL_CONFIG.trace_sample_rate = 0.0
        GLOBAL_CONFIG.serve_affinity_weight = old_weight
        serve.delete("llmx")


@pytest.mark.chaos
def test_stalled_replica_health_restarted_and_stream_resumes(cfg, params, chaos_node):
    """A replica whose step loop stalls (process alive, actor answering) is
    caught by the serve controller's health poll, killed as unhealthy and
    replaced; the interrupted stream resumes on the replacement and still
    delivers the exact sequence. The surgically armed stall plan wins over
    the node's kill plan on the stalled replica, and the replacement's
    resumed tail stays inside the kill plan's 6-consult skip window."""
    ec = EngineConfig(
        num_blocks=64, block_size=8, prefill_buckets=(8, 32),
        decode_buckets=(1, 4), max_decode_batch=4, max_new_tokens_default=8,
        step_stall_unhealthy_s=1.0,
    )
    dep = serve.llm_deployment(
        cfg, engine=ec, name="llmst", num_replicas=1,
        route_prefix="/llmst", ray_actor_options=CHAOS_REPLICA,
    )
    try:
        handle = serve.run(dep.bind(device="cpu"))
        ctrl = _controller()
        replicas = rt.get(ctrl.get_replicas.remote("llmst"), timeout=60)
        assert len(replicas) == 1
        rt.get(replicas[0].handle_request.remote(
            "testing_arm_replica_chaos", ["stall:1.0:30.0:1", 5], {}, ""), timeout=60)
        prompt = [4, 8, 1, 9]
        ref = InferenceEngine(cfg, params, ec).start()
        try:
            expected = list(ref.generate(prompt, max_new_tokens=6))
        finally:
            ref.stop()
        t0 = time.monotonic()
        toks = list(handle.stream({"prompt": prompt, "max_new_tokens": 6},
                                  _method="generate", _timeout=180))
        assert toks == expected
        assert time.monotonic() - t0 < 28, "stream waited out the stall"
        st = rt.get(ctrl.wait_status.remote("llmst", min_replicas=1, timeout_s=60), timeout=90)
        assert st["restarts"]["unhealthy"] >= 1, st
    finally:
        serve.delete("llmst")
