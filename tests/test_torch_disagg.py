"""Disaggregated prefill/decode serving and the cluster KV tier behind the
port's serve layer, on one module-scoped cluster of the port's, with
``device="cpu"`` replicas: a port of ``tests/test_disagg.py`` and of the
SIGKILL mid-decode E2E of ``tests/test_stream_resume_tier.py``.

* byte-exact handoff: a temperature>0 request prefilled on the prefill
  pool and decoded on the decode pool yields the stream one engine gives
  alone, with the migration provably used (the decode replica's prefix
  hit covers the exported tokens, and ``raytpu_kv_migration_transfers_total``
  grows with no fallback counted);
* fallback ladder: a descriptor failing the digest gate, and a prompt
  under ``serve_disagg_min_prompt_tokens``, degrade to plain generation,
  counted, with the same tokens;
* seeded replica chaos: ``kill_mid_export`` on the prefill replica and
  ``kill_mid_import`` on the decode replica leave every stream byte-exact
  with zero client errors, and the schedule replays from its seed;
* the tier E2E: the affinity-hot replica of a ``kv_tier=True`` deployment
  is SIGKILLed mid-decode under 4 streams; every stream is byte-exact, the
  resumes go through tier fault-in (the replay-token counter does not
  move, tier hits grow), and the replacement boots advertising the shared
  prefix from the node daemon's tier registry.

The reference is the port's own engine on the replicas' weights (seed 0
on the CPU), so every comparison is byte-exact.
"""

import threading
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.inference.kv_cache import _chain_digest
from ray_tpu_torch.inference.kv_transfer import migration_metrics
from ray_tpu_torch.models.llama import LlamaConfig, init_params
from ray_tpu_torch.util.reaper import find_runtime_pids

torch.set_num_threads(1)

#: 24 tokens = 3 full blocks at block_size 8
PROMPT = [5, 9, 2, 7, 1, 3, 8, 4] * 3
SHARED = [12, 7, 3, 9, 1, 5, 2, 8] * 3
CHAOS_SEED = 1307
#: the tier E2E's own bound on its streams and waits
E2E_TIMEOUT_S = 90


def _engine_cfg(**kw):
    return EngineConfig(num_blocks=64, block_size=8, prefill_buckets=(8, 32),
                        decode_buckets=(1, 2, 4), max_decode_batch=4,
                        max_new_tokens_default=8, warmup=False, **kw)


@pytest.fixture(scope="module")
def cluster():
    # one torch thread in each of the cluster's processes, as in this one
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        c = Cluster(num_cpus=4)
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
def disagg_handle(cluster, cfg):
    dep = serve.llm_deployment(
        cfg, engine=_engine_cfg(), name="dllm", disaggregated=True,
        prefill_replicas=1, decode_replicas=1, route_prefix="/dllm",
        ray_actor_options={"num_cpus": 0.25},
    )
    try:
        yield serve.run(dep.bind(device="cpu"))
    finally:
        if "dllm" in serve.status():
            serve.delete("dllm")


@pytest.fixture(scope="module")
def reference_engine(cfg):
    """Undisturbed single engine on the replicas' weights and engine config."""
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"), _engine_cfg()).start()
    yield eng
    eng.stop()


def _controller():
    return rt.get_actor("__serve_controller__")


def _replicas(name):
    return rt.get(_controller().get_replicas.remote(name), timeout=30)


def _call(replica, method, args=(), timeout=60):
    return rt.get(replica.handle_request.remote(method, list(args), {}, ""), timeout=timeout)


def _replica_metrics(replica) -> str:
    addr = _call(replica, "metrics_address")
    return urllib.request.urlopen(f"http://{addr}/metrics", timeout=10).read().decode()


def _scrape(body: str, name: str) -> float:
    return sum(float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
               if line.startswith(name) and " " in line)


def _stream(handle, req, timeout=120):
    return list(handle.stream(dict(req), _method="generate", _timeout=timeout))


def _ref(engine, prompt, **kw):
    return list(engine.generate(prompt, **kw))


# ---------------------------------------------------------------------------
# happy path


def test_byte_exact_handoff_with_sampling(disagg_handle, reference_engine):
    """Prefill on pool A, decode on pool B: the stream one engine gives
    alone, at temperature>0, with the migration used and nothing fallen
    back from."""
    fallbacks = migration_metrics()["fallbacks"]
    fb_before = sum(fallbacks._values.values())
    decode = _replicas("dllm")[0]
    body0 = _replica_metrics(decode)
    stats0 = _call(decode, "engine_stats")["prefix_cache"]
    out = _stream(disagg_handle, {"prompt": PROMPT, "max_new_tokens": 8,
                                  "temperature": 0.8, "seed": 42})
    assert out == _ref(reference_engine, PROMPT, max_new_tokens=8, temperature=0.8, seed=42)
    # the decode replica admitted the request over the 24 imported tokens
    # (23 of them skipped; the COW tail recomputed the last)
    ps = _call(decode, "engine_stats")["prefix_cache"]
    assert ps["hits_total"] - stats0["hits_total"] == 1, ps
    assert ps["tokens_saved_total"] - stats0["tokens_saved_total"] == len(PROMPT) - 1, ps
    body = _replica_metrics(decode)
    assert (_scrape(body, "raytpu_kv_migration_transfers_total ")
            - _scrape(body0, "raytpu_kv_migration_transfers_total ")) == 1
    assert _scrape(body, "raytpu_kv_migration_fallbacks_total") == \
        _scrape(body0, "raytpu_kv_migration_fallbacks_total")
    assert sum(fallbacks._values.values()) == fb_before  # the router's rungs too
    prefill = _replicas("dllm-prefill")[0]
    assert _call(prefill, "engine_stats")["scheduler"]["total_admitted"] >= 1
    hist = migration_metrics()["handoff"]
    assert sum(ent[-1] for ent in hist._values.values()) >= 1  # noqa: SLF001


def test_greedy_handoff_matches_and_reuses_radix(disagg_handle, reference_engine):
    """Greedy across the handoff, twice: the second export is served from
    the prefill replica's own radix cache, and both streams are exact."""
    decode = _replicas("dllm")[0]
    saved0 = _call(decode, "engine_stats")["prefix_cache"]["tokens_saved_total"]
    out1 = _stream(disagg_handle, {"prompt": PROMPT, "max_new_tokens": 6})
    out2 = _stream(disagg_handle, {"prompt": PROMPT, "max_new_tokens": 6})
    ref = _ref(reference_engine, PROMPT, max_new_tokens=6)
    assert out1 == ref and out2 == ref, (out1, out2, ref)
    saved = _call(decode, "engine_stats")["prefix_cache"]["tokens_saved_total"]
    assert saved - saved0 >= 2 * (len(PROMPT) - 1)


# ---------------------------------------------------------------------------
# failure -> fallback ladder


def test_digest_mismatch_falls_back_to_plain_prefill(disagg_handle, reference_engine):
    """A descriptor failing the digest-before-attach gate degrades to a
    plain prefill: the same tokens, the fallback counted, nothing imported
    (a prompt the decode replica has not seen, so no prefix is warm)."""
    fresh = [7, 2, 9, 4, 6, 1, 3, 5] * 3
    prefill = _replicas("dllm-prefill")[0]
    desc = _call(prefill, "prefill_export", [{"prompt": fresh, "request_id": "corrupt.pf"}],
                 timeout=120)
    assert desc is not None and desc["dtype"] == "float32"
    assert desc["tokens"] == 24 and desc["object_id"] is not None  # through the store
    desc = dict(desc)
    desc["crc32"] = (desc["crc32"] ^ 0xFF) & 0xFFFFFFFF
    decode = _replicas("dllm")[0]
    saved0 = _call(decode, "engine_stats")["prefix_cache"]["tokens_saved_total"]
    out = _call(decode, "__call__", [{"prompt": fresh + [3], "max_new_tokens": 4,
                                      "kv_import": desc}], timeout=120)
    assert out["tokens"] == _ref(reference_engine, fresh + [3], max_new_tokens=4)
    body = _replica_metrics(decode)
    assert 'raytpu_kv_migration_fallbacks_total{reason="transfer"}' in body
    assert 'raytpu_kv_migration_failures_total{stage="digest"}' in body
    # nothing was imported: the plain prefill found no new prefix
    assert _call(decode, "engine_stats")["prefix_cache"]["tokens_saved_total"] == saved0


def test_short_prompt_skips_migration(disagg_handle, reference_engine):
    fallbacks = migration_metrics()["fallbacks"]
    before = fallbacks._values.get(("short_prompt",), 0.0)  # noqa: SLF001
    out = _stream(disagg_handle, {"prompt": [3, 1, 4], "max_new_tokens": 4})
    assert out == _ref(reference_engine, [3, 1, 4], max_new_tokens=4)
    assert fallbacks._values.get(("short_prompt",), 0.0) > before  # noqa: SLF001


# ---------------------------------------------------------------------------
# seeded replica chaos at the export/import consult points


def test_chaos_kill_prefill_mid_export_degrades_gracefully(disagg_handle, reference_engine):
    prefill = _replicas("dllm-prefill")[0]
    _call(prefill, "testing_arm_replica_chaos", ["kill_mid_export:1.0", CHAOS_SEED])
    fallbacks = migration_metrics()["fallbacks"]
    before = sum(fallbacks._values.values())  # noqa: SLF001
    old_timeout = GLOBAL_CONFIG.serve_disagg_handoff_timeout_s
    # a tight handoff budget pins the fallback rung (the replacement is
    # unarmed, so an unbounded budget would eventually succeed on retry)
    GLOBAL_CONFIG.serve_disagg_handoff_timeout_s = 2.0
    try:
        n = 3
        results, errors = {}, {}

        def consume(i):
            try:
                results[i] = _stream(disagg_handle, {"prompt": PROMPT, "max_new_tokens": 6,
                                                     "temperature": 0.7, "seed": 100 + i})
            except Exception as e:  # noqa: BLE001
                errors[i] = e

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        for i in range(n):
            assert results[i] == _ref(reference_engine, PROMPT, max_new_tokens=6,
                                      temperature=0.7, seed=100 + i)
        assert sum(fallbacks._values.values()) > before  # noqa: SLF001
    finally:
        GLOBAL_CONFIG.serve_disagg_handoff_timeout_s = old_timeout
    st = rt.get(_controller().wait_status.remote("dllm-prefill", min_replicas=1, timeout_s=90),
                timeout=120)
    assert st["replicas"] >= 1, st


def test_chaos_kill_decode_mid_import_resumes_byte_exact(disagg_handle, reference_engine):
    rt.get(_controller().wait_status.remote("dllm-prefill", min_replicas=1, timeout_s=90),
           timeout=120)
    decode = _replicas("dllm")[0]
    _call(decode, "testing_arm_replica_chaos", ["kill_mid_import:1.0", CHAOS_SEED + 1])
    out = _stream(disagg_handle, {"prompt": PROMPT, "max_new_tokens": 6,
                                  "temperature": 0.9, "seed": 777}, timeout=180)
    assert out == _ref(reference_engine, PROMPT, max_new_tokens=6, temperature=0.9, seed=777)
    st = rt.get(_controller().wait_status.remote("dllm", min_replicas=1, timeout_s=90),
                timeout=120)
    assert st["replicas"] >= 1, st


def test_fault_schedule_replays_from_seed():
    from ray_tpu_torch.util.chaos import ReplicaFaultPlan

    phases = ["prefill", "export", "decode", "import", "export", "decode"]
    spec = "kill_mid_export:0.5:0:3,kill_mid_import:0.5:0:3"

    def schedule():
        plan = ReplicaFaultPlan(spec, CHAOS_SEED)
        return [plan.consult(p) for p in phases]

    assert schedule() == schedule()
    assert any(f is not None for f in schedule())


def test_prefix_digest_exports_complete_spines_under_budget():
    from ray_tpu_torch.inference.kv_cache import PagedBlockManager, prefix_block_hashes

    bs = 4
    mgr = PagedBlockManager(64, bs, prefix_cache_enabled=True)
    deep, shallow = list(range(100, 116)), list(range(200, 208))
    for rid, tokens in (("deep", deep), ("shallow", shallow)):
        assert mgr.grow_to(rid, len(tokens))
        mgr.register_prefix(rid, tokens)
        mgr.free(rid)
    assert len(mgr.prefix_digest()) == 6
    deep_hashes = prefix_block_hashes(deep, bs)
    shallow_hashes = prefix_block_hashes(shallow, bs)
    for budget in (2, 3, 4, 5, 6):
        out = set(mgr.prefix_digest(max_entries=budget))
        assert len(out) <= budget
        for chain in (deep_hashes, shallow_hashes):
            for i, h in enumerate(chain):
                if h in out:
                    assert all(a in out for a in chain[: i + 1]), (budget, i, out)
    out3 = set(mgr.prefix_digest(max_entries=3))
    assert set(shallow_hashes) <= out3
    deep_in = [h for h in deep_hashes if h in out3]
    assert deep_in == deep_hashes[: len(deep_in)], (deep_in, out3)


# ---------------------------------------------------------------------------
# the tier E2E: SIGKILL mid-decode, resumed through tier fault-in


def _digests(tokens, bs=8):
    out, prev = [], b""
    for end in range(bs, len(tokens) + 1, bs):
        prev = _chain_digest(prev, tokens[end - bs : end])
        out.append(prev)
    return out


def _tier_adverts(replica):
    return _call(replica, "routing_stats").get("kv_tier") or {}


@pytest.mark.chaos
def test_e2e_sigkill_mid_decode_resumes_via_tier_fault_in(cluster, cfg, reference_engine):
    """The affinity-hot replica of a ``kv_tier=True`` deployment is
    SIGKILLed mid-decode under 4 streams: every client gets the byte-exact
    undisturbed stream, the resumes went through tier fault-in (the
    replay-token counter does not move, tier hits grow), and the
    controller's replacement adverts the shared prefix it never served,
    recovered from the node daemon's tier registry at boot."""
    from ray_tpu_torch.observability.rpc_metrics import (
        STREAM_RESUME_REPLAY_TOKENS,
        STREAM_RESUMES,
    )

    t_start = time.monotonic()
    n, max_new = 4, 12
    prompts = {i: SHARED + [60 + i] for i in range(n)}
    expected = {i: _ref(reference_engine, prompts[i], max_new_tokens=max_new,
                        temperature=0.7, seed=100 + i) for i in range(n)}
    dep = serve.llm_deployment(
        cfg, engine=_engine_cfg(), name="llmtier", num_replicas=2, kv_tier=True,
        route_prefix="/llmtier", ray_actor_options={"num_cpus": 0.25},
    )
    old_weight = GLOBAL_CONFIG.serve_affinity_weight
    GLOBAL_CONFIG.serve_affinity_weight = 1e6
    try:
        handle = serve.run(dep.bind(device="cpu"))
        ctrl = _controller()
        rt.get(ctrl.wait_status.remote("llmtier", min_replicas=2, timeout_s=E2E_TIMEOUT_S),
               timeout=E2E_TIMEOUT_S + 30)
        # a warm request prefill-publishes the 3 shared blocks on one
        # replica; its gossip then pins the streams there by affinity
        before = {r.actor_id: len(_tier_adverts(r)) for r in _replicas("llmtier")}
        _stream(handle, {"prompt": SHARED + [42], "max_new_tokens": 2}, timeout=E2E_TIMEOUT_S)
        time.sleep(3 * GLOBAL_CONFIG.serve_replica_stats_period_s)
        hot = [r for r in _replicas("llmtier")
               if len(_tier_adverts(r)) > before.get(r.actor_id, 0)]
        assert len(hot) == 1, "the warm request did not land on exactly one replica"
        hot = hot[0]
        # 4 more decode consults, then SIGKILL: each stream has at most 7
        # delivered tokens, so the 24 shared tier tokens cover the resume
        _call(hot, "testing_arm_replica_chaos", ["kill_mid_decode:1.0:4", 4242])
        resumes0 = STREAM_RESUMES._values.get(("llmtier",), 0.0)
        replay0 = STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0)
        hits0 = sum(_scrape(_replica_metrics(r), "raytpu_kv_tier_hits_total")
                    for r in _replicas("llmtier"))
        results, errors = {}, {}

        def consume(i):
            try:
                results[i] = _stream(handle, {"prompt": prompts[i], "max_new_tokens": max_new,
                                              "temperature": 0.7, "seed": 100 + i,
                                              "request_id": f"tier{i}"},
                                     timeout=E2E_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001
                errors[i] = e

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=E2E_TIMEOUT_S + 30)
        assert not any(t.is_alive() for t in threads), "a stream outlived its timeout"
        assert not errors, errors
        assert results == expected
        assert STREAM_RESUMES._values.get(("llmtier",), 0.0) - resumes0 > 0, \
            "the kill never landed mid-stream"
        # failover went through tier fault-in: no prefix was re-prefilled
        assert STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0) - replay0 == 0.0
        # wait_status returns once 2 replicas are listed, which the dead
        # one still is until the controller's health poll books its death
        deadline = time.monotonic() + E2E_TIMEOUT_S
        while True:
            st = rt.get(ctrl.wait_status.remote("llmtier", min_replicas=2,
                                                timeout_s=E2E_TIMEOUT_S),
                        timeout=E2E_TIMEOUT_S + 30)
            if st["restarts"]["death"] >= 1 or time.monotonic() > deadline:
                break
            time.sleep(0.25)
        assert st["replicas"] == 2 and st["restarts"]["death"] >= 1, st
        live = _replicas("llmtier")
        bodies = [_replica_metrics(r) for r in live]
        assert sum(_scrape(b, "raytpu_kv_tier_hits_total") for b in bodies) > hits0, [
            [line for line in b.splitlines() if line.startswith("raytpu_kv_tier")]
            + [_call(r, "engine_stats")["prefix_cache"]] for r, b in zip(live, bodies)]
        # warm restart: every live replica, the replacement included,
        # adverts the shared chain
        chain = {d.hex() for d in _digests(SHARED)}
        for r in live:
            assert chain <= set(_tier_adverts(r))
        assert time.monotonic() - t_start < 3 * E2E_TIMEOUT_S
    finally:
        GLOBAL_CONFIG.serve_affinity_weight = old_weight
        serve.delete("llmtier")


def test_delete_cascades_to_prefill_pool(disagg_handle):
    """``serve.delete`` of a disaggregated deployment tears down the paired
    prefill pool too (runs last: it deletes the module's deployment)."""
    assert "dllm-prefill" in serve.status()
    serve.delete("dllm")
    st = serve.status()
    assert "dllm" not in st and "dllm-prefill" not in st, st
