"""The port's inference engine (``ray_tpu_torch.inference``): ports of the
cluster-free tests of ``tests/test_inference.py`` (paged KV block manager,
continuous batching, engine edge cases, prefix cache and COW), run on the
CPU on ``LlamaConfig.tiny()``.

The engine's contracts are byte-exact within the port: every stream equals
the port's own dense greedy loop (``models.llama.forward``) on the same
weights. ``EngineConfig(warmup=False)`` wherever compile counts are not
under test. The ``cuda``-marked tests run the same contracts on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.inference import (
    ContinuousBatchingScheduler,
    EngineConfig,
    EngineDrainingError,
    InferenceEngine,
    PagedBlockManager,
    Request,
    RequestFailedError,
)
from ray_tpu_torch.inference.scheduler import FAILED, QUEUED
from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 0, device="cpu")


def dense_greedy(cfg, params, prompt, n):
    """Greedy continuation through the dense ``forward``, padded to
    max_seq_len so every step has one shape (causal masking makes the
    padding inert)."""
    dev = params.embed.device
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            padded = torch.zeros((1, cfg.max_seq_len), dtype=torch.long, device=dev)
            padded[0, : len(toks)] = torch.tensor(toks, device=dev)
            nxt = int(forward(cfg, params, padded)[0, len(toks) - 1].argmax())
            out.append(nxt)
            toks.append(nxt)
    return out


def engine_config(**overrides):
    kw = dict(num_blocks=32, block_size=8, prefill_buckets=(16,), decode_buckets=(1,),
              max_decode_batch=1, warmup=False)
    kw.update(overrides)
    return EngineConfig(**kw)


# ---------------------------------------------------------------------------
# host-side accounting (no model compute)


def test_block_manager_alloc_free_evict():
    mgr = PagedBlockManager(num_blocks=8, block_size=4)
    assert mgr.usable_blocks == 7  # block 0 reserved
    assert mgr.grow_to("a", 9)  # 3 blocks
    assert mgr.used_blocks == 3
    assert 0 not in mgr.owned("a")  # null block never handed out
    # all-or-nothing: 5 more blocks don't fit 4 free
    assert not mgr.grow_to("b", 20)
    assert mgr.owned("b") == []
    assert mgr.grow_to("b", 16)  # 4 blocks: exactly fits
    assert mgr.free_blocks == 0
    row = mgr.table_row("a", 6)
    assert len(row) == 6 and row[3:] == [0, 0, 0]
    assert mgr.evict("a") == 3
    assert mgr.total_evictions == 1
    assert mgr.free_blocks == 3
    assert mgr.free("b") == 4
    assert mgr.stats()["utilization"] == 0.0


def test_scheduler_admission_queues_then_admits():
    mgr = PagedBlockManager(num_blocks=5, block_size=4)  # 4 usable
    sched = ContinuousBatchingScheduler(mgr, max_decode_batch=4)
    a = Request("a", prompt=list(range(1, 12)))  # needs 3 blocks (12 tokens)
    b = Request("b", prompt=list(range(1, 8)))  # needs 2 blocks
    sched.add(a)
    sched.add(b)
    plan = sched.schedule()
    assert [r.request_id for r in sched.running] == ["a"]
    assert sched.queue_depth() == 1
    assert plan.prefills and plan.prefills[0][0] is a
    sched.finish(a)  # a's blocks return to the pool
    sched.schedule()
    assert [r.request_id for r in sched.running] == ["b"]
    assert sched.queue_depth() == 0
    assert sched.total_admitted == 2


def test_scheduler_preempts_lowest_priority_for_block_growth():
    mgr = PagedBlockManager(num_blocks=6, block_size=4)  # 5 usable
    sched = ContinuousBatchingScheduler(mgr, max_decode_batch=4)
    lo = Request("lo", prompt=list(range(1, 8)), priority=0)  # 2 blocks
    hi = Request("hi", prompt=list(range(1, 8)), priority=1)  # 2 blocks
    sched.add(lo)
    sched.add(hi)
    sched.schedule()
    assert len(sched.running) == 2 and mgr.free_blocks == 1
    for r in (lo, hi):
        r.prefill_pos = len(r.prompt)
        r.generated.extend([5] * 4)  # context 11 -> needs 3 blocks
    plan = sched.schedule()
    # hi (priority 1) takes the free block; lo stalls instead of
    # preempting higher-priority work
    assert hi in plan.decodes
    assert lo not in plan.decodes
    assert lo in sched.running
    hi.priority = -1
    lo.generated.extend([5] * 1)
    plan = sched.schedule()
    assert lo in plan.decodes
    assert hi.state == QUEUED and hi.preemptions == 1
    assert sched.waiting[0] is hi  # readmission from the queue FRONT
    assert mgr.total_evictions == 1


def test_expired_request_behind_stuck_head_is_reaped():
    class _Expired:
        expired = True

    mgr = PagedBlockManager(4, 4)  # 3 usable blocks
    sched = ContinuousBatchingScheduler(mgr)
    head = Request(request_id="head", prompt=list(range(40)))  # needs 11 blocks: stuck
    behind = Request(request_id="behind", prompt=[1, 2], deadline=_Expired())
    sched.add(head)
    sched.add(behind)
    plan = sched.schedule()
    assert behind in plan.reaped and behind.state == FAILED
    assert head.state == QUEUED and sched.queue_depth() == 1


def test_prefix_cache_manager_hit_lru_and_refcounts():
    mgr = PagedBlockManager(8, 4, prefix_cache_enabled=True)  # 7 usable
    toks = list(range(10, 22))  # 12 tokens = 3 full blocks
    assert mgr.grow_to("a", 12)
    assert mgr.register_prefix("a", toks) == 3
    assert mgr.free("a") == 3
    assert mgr.used_blocks == 0 and mgr.cached_blocks == 3
    cached, cow = mgr.acquire_prefix("b", toks[:8] + [99, 98, 97, 96])
    assert cached == 8 and cow == []
    shared = mgr.owned("b")
    assert len(shared) == 2 and all(mgr.refcount(x) == 1 for x in shared)
    assert mgr.grow_to("b", 13)
    assert mgr.grow_to("c", 4 * (7 - 3 - 1))
    assert mgr.free_blocks == 0
    stats = mgr.prefix_stats()
    assert stats["indexed_blocks"] < 3  # LRU eviction dropped index entries
    mgr.free("b")
    mgr.free("c")
    assert mgr.used_blocks == 0


def test_prefix_cache_cow_under_preemption_accounting():
    mgr = PagedBlockManager(8, 4, prefix_cache_enabled=True)  # 7 usable
    p = list(range(30, 38))  # 8 tokens = 2 full blocks
    assert mgr.grow_to("A", 9)  # 3 blocks
    assert mgr.register_prefix("A", p) == 2
    a_blocks = mgr.owned("A")
    cached, cow = mgr.acquire_prefix("B", p + [50, 51])
    assert cached == 8 and cow == []
    assert mgr.owned("B")[:2] == a_blocks[:2]
    assert mgr.grow_to("B", 11)
    assert [mgr.refcount(x) for x in a_blocks[:2]] == [2, 2]
    assert mgr.used_blocks == 4  # 3 (A) + 1 private tail (B)
    assert mgr.evict("B") == 3
    assert mgr.total_evictions == 1
    assert [mgr.refcount(x) for x in a_blocks[:2]] == [1, 1]
    assert mgr.used_blocks == 3 and mgr.owned("A") == a_blocks
    cached, _ = mgr.acquire_prefix("B", p + [50, 51])
    assert cached == 8
    assert mgr.grow_to("B", 11)
    mgr.free("B")
    mgr.free("A")
    assert mgr.used_blocks == 0
    assert mgr.free_blocks == 7
    assert mgr.cached_blocks == 2
    assert all(mgr.refcount(x) == 0 for x in range(1, 8))
    cached, cow = mgr.acquire_prefix("C", p)
    assert cached == len(p) - 1  # one token recomputes into the copy
    assert len(cow) == 1
    src, dst = cow[0]
    assert mgr.owned("C")[-1] == dst and mgr.refcount(src) == 1  # pinned
    mgr.cow_copied("C")
    assert mgr.refcount(src) == 0
    assert mgr.cow_copies_total == 1
    mgr.free("C")
    assert mgr.used_blocks == 0 and mgr.free_blocks == 7


# ---------------------------------------------------------------------------
# engine


@pytest.fixture(scope="module")
def engine(cfg, params):
    # warmed: the compile accounting is under test here
    ec = EngineConfig(
        num_blocks=64, block_size=8, prefill_buckets=(8, 16),
        decode_buckets=(1, 2, 4, 8), max_decode_batch=8,
        max_new_tokens_default=8,
    )
    eng = InferenceEngine(cfg, params, ec).start()
    yield eng
    eng.stop()


def test_engine_concurrent_streams_match_dense_zero_recompiles(cfg, params, engine):
    rs = np.random.RandomState(3)
    prompts = [
        [int(x) for x in rs.randint(1, cfg.vocab_size, size=n)]
        for n in (5, 9, 12, 4, 7, 6)
    ]
    results = {}

    def consume(i):
        results[i] = list(engine.generate(prompts[i], max_new_tokens=6))

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i, p in enumerate(prompts):
        assert results[i] == dense_greedy(cfg, params, p, 6), f"prompt {i}"
    assert engine.runner.recompiles_after_warmup() == 0
    # prefill + decode buckets + the COW block-copy program
    assert engine.runner.compile_count() == 2 + 4 + 1
    assert engine.blocks.used_blocks == 0


def test_engine_temperature_sampling_reproducible(cfg, engine):
    prompt = [3, 1, 4, 1, 5]
    a = list(engine.generate(prompt, max_new_tokens=6, temperature=0.8, seed=42))
    b = list(engine.generate(prompt, max_new_tokens=6, temperature=0.8, seed=42))
    assert a == b
    assert len(a) == 6


def test_engine_shared_prefix_matches_dense_with_zero_recompiles(cfg, params, engine):
    ps0 = engine.blocks.prefix_stats()
    sys_prompt = [91, 17, 53, 28, 64, 39, 75, 46] * 2  # 16 tokens = 2 blocks
    tails = ([101, 7], [55, 9])
    outs = [list(engine.generate(sys_prompt + t, max_new_tokens=6)) for t in tails]
    for t, out in zip(tails, outs):
        assert out == dense_greedy(cfg, params, sys_prompt + t, 6)
    # exact repeat of a FULL prompt: every block hits -> COW + 1-token tail
    rep1 = list(engine.generate(sys_prompt, max_new_tokens=6))
    rep2 = list(engine.generate(sys_prompt, max_new_tokens=6))
    assert rep1 == rep2 == dense_greedy(cfg, params, sys_prompt, 6)
    ps1 = engine.blocks.prefix_stats()
    assert ps1["hits_total"] - ps0["hits_total"] >= 2
    assert ps1["tokens_saved_total"] - ps0["tokens_saved_total"] >= 16 + 15
    assert ps1["cow_copies_total"] - ps0["cow_copies_total"] >= 1
    assert engine.runner.recompiles_after_warmup() == 0
    assert engine.blocks.used_blocks == 0


def test_engine_shared_prefix_equals_prefix_cache_off(cfg, params):
    """The same shared-prefix traffic with the prefix cache on and off
    streams identical tokens (the cached KV is what a prefill writes)."""
    sys_prompt = [12, 40, 7, 99, 3, 64, 8, 1] * 2
    prompts = [sys_prompt + [5], sys_prompt, sys_prompt + [6, 2], sys_prompt]
    outs = {}
    for on in (True, False):
        eng = InferenceEngine(cfg, params, engine_config(
            prefill_buckets=(8, 32), prefix_cache_enabled=on)).start()
        try:
            outs[on] = [list(eng.generate(p, max_new_tokens=8)) for p in prompts]
            saved = eng.blocks.prefix_stats()["tokens_saved_total"]
        finally:
            eng.stop()
        assert (saved > 0) == on
    assert outs[True] == outs[False]


def test_engine_block_exhaustion_queues_then_admits(cfg, params):
    # pool fits ONE max-length sequence (plus null): the second request
    # must wait in the admission queue until the first finishes
    ec = engine_config(num_blocks=9, decode_buckets=(1, 2), max_decode_batch=2,
                       max_new_tokens_default=8)
    eng = InferenceEngine(cfg, params, ec).start()
    try:
        p1 = [1, 2, 3] * 5  # 15 tokens -> 2 blocks, grows while decoding
        p2 = [4, 5, 6] * 5
        r1 = eng.submit(p1, max_new_tokens=30)  # ends holding 6 blocks
        deadline = time.monotonic() + 10
        while eng.blocks.used_blocks == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        r2 = eng.submit(p2, max_new_tokens=30)
        saw_queued = False
        for _ in range(1000):
            if eng.scheduler.queue_depth() > 0:
                saw_queued = True
                break
            time.sleep(0.001)
        out1 = list(eng.tokens(r1, timeout=30))
        out2 = list(eng.tokens(r2, timeout=30))
        assert saw_queued, "second request never waited for blocks"
        assert out1 == dense_greedy(cfg, params, p1, 30)
        assert out2 == dense_greedy(cfg, params, p2, 30)
        assert eng.scheduler.total_admitted == 2
        assert eng.blocks.used_blocks == 0
    finally:
        eng.stop()


def test_engine_mid_decode_cancellation_frees_blocks(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config()).start()
    try:
        rid = eng.submit([1, 2, 3, 4, 5], max_new_tokens=500)
        it = eng.tokens(rid, timeout=30)
        first = [next(it), next(it)]  # stream is live mid-decode
        assert len(first) == 2
        assert eng.blocks.used_blocks > 0
        assert eng.cancel(rid)
        rest = list(it)  # cancel surfaces as a clean end-of-stream
        assert len(rest) < 500
        deadline = time.monotonic() + 10
        while eng.blocks.used_blocks and time.monotonic() < deadline:
            time.sleep(0.002)
        assert eng.blocks.used_blocks == 0
        assert not eng.scheduler.has_work()
    finally:
        eng.stop()


def test_engine_preemption_readmission_matches_dense(cfg, params):
    # pool too small for two grown sequences: the lower-priority request is
    # evicted mid-decode and re-prefills prompt+generated on readmission
    ec = engine_config(num_blocks=11, prefill_buckets=(16, 32), decode_buckets=(1, 2),
                       max_decode_batch=2, max_new_tokens_default=40)
    eng = InferenceEngine(cfg, params, ec).start()
    try:
        lo_p = [1, 2, 3, 4, 5, 6, 7] * 2  # 14 tokens
        hi_p = [8, 9, 10, 11, 12, 13] * 2  # 12 tokens
        lo = eng.submit(lo_p, max_new_tokens=40, priority=0)
        hi = eng.submit(hi_p, max_new_tokens=40, priority=1)
        out_lo = list(eng.tokens(lo, timeout=60))
        out_hi = list(eng.tokens(hi, timeout=60))
        assert out_hi == dense_greedy(cfg, params, hi_p, 40)
        assert out_lo == dense_greedy(cfg, params, lo_p, 40)
        assert eng.scheduler.total_preempted >= 1
        assert eng.blocks.used_blocks == 0
    finally:
        eng.stop()


def test_engine_drain_finishes_in_flight_rejects_new(cfg, params):
    ec = engine_config(num_blocks=64, decode_buckets=(1, 2, 4), max_decode_batch=4)
    eng = InferenceEngine(cfg, params, ec).start()
    try:
        rids = [eng.submit([1 + i, 2, 3], max_new_tokens=30) for i in range(3)]
        eng.begin_drain(grace_s=30)
        with pytest.raises(EngineDrainingError):
            eng.submit([9, 9, 9])
        for i, rid in enumerate(rids):
            out = list(eng.tokens(rid, timeout=30))
            assert out == dense_greedy(cfg, params, [1 + i, 2, 3], 30)
        assert eng.wait_idle(timeout=10)
    finally:
        eng.stop()


def test_engine_drain_grace_expiry_fails_stragglers(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config(num_blocks=64))  # NOT started
    try:
        rid = eng.submit([1, 2, 3], max_new_tokens=5)
        eng.begin_drain(grace_s=0.0)  # grace already over
        eng.start()
        with pytest.raises(RequestFailedError):
            list(eng.tokens(rid, timeout=30))
    finally:
        eng.stop()


def test_engine_expired_deadline_fails_request(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config()).start()
    try:
        rid = eng.submit([1, 2, 3], max_new_tokens=5, timeout_s=0.0)
        with pytest.raises(RequestFailedError):
            list(eng.tokens(rid, timeout=30))
        assert eng.blocks.used_blocks == 0
    finally:
        eng.stop()


def test_engine_rejects_batch_beyond_buckets(cfg, params):
    with pytest.raises(ValueError, match="decode bucket"):
        InferenceEngine(cfg, params, engine_config(decode_buckets=(1, 2), max_decode_batch=4))


def test_tokens_timeout_keeps_stream_resumable(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config())  # NOT started: no tokens yet
    try:
        rid = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(TimeoutError):
            next(eng.tokens(rid, timeout=0.05))
        eng.start()
        assert len(list(eng.tokens(rid, timeout=30))) == 4
        assert eng.blocks.used_blocks == 0
    finally:
        eng.stop()


def test_abandoned_finished_stream_is_reaped(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config(finished_stream_ttl_s=0.2)).start()
    try:
        rid = eng.submit([1, 2, 3], max_new_tokens=3)
        deadline = time.monotonic() + 10
        while rid in eng._out and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rid not in eng._out and rid not in eng._finished_at
        with pytest.raises(KeyError):
            next(eng.tokens(rid))
    finally:
        eng.stop()


def test_engine_stats_books_and_health(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config()).start()
    try:
        assert eng.healthy()
        out = list(eng.generate([7, 8, 9], max_new_tokens=5))
        assert len(out) == 5
        st = eng.stats()
        assert st["scheduler"]["total_admitted"] == 1 and st["total_steps"] >= 5
        assert set(st["ttft"]) == {"p50", "p99"}
        books = eng.ledger_books()
        assert books["submitted"] == books["finished"] == 1
        rs = eng.routing_stats()
        assert rs["block_size"] == 8 and rs["queue_depth"] == 0 and not rs["draining"]
    finally:
        eng.stop()
    assert not eng.healthy()


def test_engine_runs_where_the_params_are(cfg, params):
    eng = InferenceEngine(cfg, params, engine_config())
    assert eng.runner.device == params.embed.device
    assert eng.runner.cache["k"].device == params.embed.device


def test_global_config_env_override(monkeypatch):
    from ray_tpu_torch.core.config import GlobalConfig

    monkeypatch.setenv("RAY_TPU_drain_grace_s", "2.5")
    monkeypatch.setenv("RAY_TPU_slo_flight_recorder_slots", "7")
    conf = GlobalConfig()
    conf.apply_env()
    assert conf.drain_grace_s == 2.5 and conf.slo_flight_recorder_slots == 7
    assert conf.slo_ttft_slow_s == 2.0 and conf.testing_replica_chaos == ""


@pytest.mark.parametrize("feature", [
    "kv_transfer_enabled", "kv_tier_enabled", "testing_replica_chaos", "migrate",
    "prefill_kv", "import_kv_blocks", "attach_node_drain_listener",
])
def test_unported_features_raise(cfg, params, feature, monkeypatch):
    """The features this test once held to raising naming the ROADMAP are
    ported, and each runs: KV migration (the gather/scatter shapes at
    warmup, ``prefill_kv``, ``import_kv_blocks``), the cluster KV tier
    (write-back adverts, ``begin_drain(migrate=True)``), replica chaos and
    the node drain listener."""
    from ray_tpu_torch.inference import kv_transfer
    from ray_tpu_torch.inference.engine import KvMigrationHandoff

    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4]  # 2 blocks + 4
    if feature == "kv_transfer_enabled":
        plain = InferenceEngine(cfg, params, engine_config(warmup=True))
        eng = InferenceEngine(cfg, params, engine_config(warmup=True, kv_transfer_enabled=True))
        # the gather and scatter shapes run at warmup, so a migration
        # meets no new shape
        assert eng.runner.compile_count() == plain.runner.compile_count() + 2
        eng.start()
        try:
            assert eng.prefill_kv(prompt)["kv"].shape[2] == 2
            assert eng.import_kv_blocks(prompt[:16], eng.prefill_kv(prompt)["kv"]) == 16
        finally:
            eng.stop()
        assert eng.runner.recompiles_after_warmup() == 0
        return
    if feature in ("kv_tier_enabled", "migrate"):
        eng = InferenceEngine(cfg, params, engine_config(
            kv_transfer_enabled=True, kv_tier_enabled=True, max_new_tokens_default=20)).start()
        try:
            assert eng._tier_ns
            if feature == "kv_tier_enabled":
                # the prompt's two full blocks are written back and adverted
                list(eng.generate(prompt, max_new_tokens=2))
                assert eng.flush_tier_writebacks()
                assert len(eng.routing_stats()["kv_tier"]) == 2
                return
            # a stall at every step keeps the stream live for the drain
            from ray_tpu_torch.util.chaos import ReplicaFaultPlan

            eng.testing_fault_plan = ReplicaFaultPlan("stall:1.0:0.1:9999", 1)
            rid = eng.submit(prompt, max_new_tokens=20)
            it = eng.tokens(rid, timeout=60)
            first = next(it)
            eng.begin_drain(migrate=True)
            with pytest.raises(KvMigrationHandoff):
                list(it)
            assert isinstance(first, int) and eng.draining
            assert len(eng.routing_stats()["kv_tier"]) >= 2
            assert eng.blocks.used_blocks == 0
        finally:
            eng.stop()
            with kv_transfer._LOCAL_TIER_LOCK:
                kv_transfer._LOCAL_TIER.clear()
        return
    if feature == "testing_replica_chaos":
        # the engine builds with the flag set, and the plan is consulted
        from ray_tpu_torch.inference import engine as port_engine

        monkeypatch.setattr(port_engine, "_RPLAN_CACHE", None)  # restored after
        monkeypatch.setattr(GLOBAL_CONFIG, "testing_replica_chaos", "stall:1.0:0.01:2")
        monkeypatch.setattr(GLOBAL_CONFIG, "testing_replica_chaos_seed", 11)
        eng = InferenceEngine(cfg, params, engine_config()).start()
        try:
            assert len(list(eng.generate([1, 2, 3], max_new_tokens=4))) == 4
        finally:
            eng.stop()
        plan = port_engine.active_replica_fault_plan()
        assert plan.seed == 11 and plan.injections == 2 and plan.consults >= 4
        return
    eng = InferenceEngine(cfg, params, engine_config(kv_transfer_enabled=True))
    if feature == "attach_node_drain_listener":
        # no cluster: the reference's local-mode branch, explicit drain only
        assert eng.attach_node_drain_listener() is None
        assert not eng.draining
        assert eng._listener_backend is None and eng._node_listener is None
        eng.begin_drain(grace_s=5.0)
        assert eng.draining
        with pytest.raises(EngineDrainingError):
            eng.submit([1, 2, 3])
        eng.detach_node_drain_listener()
        return
    src = InferenceEngine(cfg, params, engine_config(kv_transfer_enabled=True)).start()
    eng.start()
    try:
        payload = src.prefill_kv(prompt)
        assert payload["tokens"] == prompt[:16] and payload["block_size"] == 8
        assert payload["dtype"] == "float32" and payload["kv"].shape == (2, 2, 2, 8, 2, 16)
        assert src.blocks.used_blocks == 0  # no token sampled, blocks back
        if feature == "import_kv_blocks":
            want = list(src.generate(prompt, max_new_tokens=6))
            assert eng.import_kv_blocks(payload["tokens"], payload["kv"]) == 16
            assert list(eng.generate(prompt, max_new_tokens=6)) == want
            assert eng.blocks.prefix_tokens_saved_total == 16
    finally:
        src.stop()
        eng.stop()
    assert not eng.draining


def test_routing_stats_keys_match_jax_engine(cfg, params):
    """The gossip the serve router reads has the JAX engine's keys, in its
    order, ``kv_tier`` included (``{}`` with the tier off)."""
    import jax

    from ray_tpu.inference import EngineConfig as JaxEngineConfig
    from ray_tpu.inference import InferenceEngine as JaxEngine
    from ray_tpu.models import llama as jl

    jcfg = jl.LlamaConfig.tiny()
    jeng = JaxEngine(jcfg, jl.init_params(jcfg, jax.random.PRNGKey(0)),
                     JaxEngineConfig(num_blocks=32, block_size=8, prefill_buckets=(16,),
                                     decode_buckets=(1,), max_decode_batch=1, warmup=False))
    eng = InferenceEngine(cfg, params, engine_config())
    ours, ref = eng.routing_stats(), jeng.routing_stats()
    assert list(ours) == list(ref)
    assert ours["kv_tier"] == ref["kv_tier"] == {}


# ---------------------------------------------------------------------------
# on the card (part (c) of chip_smoke.py's serve phase, as tests)


@pytest.fixture
def cuda_params(cfg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    return init_params(cfg, 0)


@pytest.mark.cuda
def test_cuda_engine_greedy_matches_dense(cfg, cuda_params):
    eng = InferenceEngine(cfg, cuda_params, engine_config(
        num_blocks=64, decode_buckets=(1, 2, 4), max_decode_batch=4)).start()
    try:
        prompts = [[5, 9, 12, 4], [7, 7, 1, 3, 9, 2, 8, 8, 4], [200, 3]]
        rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        outs = [list(eng.tokens(r, timeout=60)) for r in rids]
    finally:
        eng.stop()
    assert eng.runner.cache["k"].device.type == "cuda"
    for p, out in zip(prompts, outs):
        assert out == dense_greedy(cfg, cuda_params, p, 12)


@pytest.mark.cuda
def test_cuda_shared_prefix_equals_prefix_cache_off(cfg, cuda_params):
    test_engine_shared_prefix_equals_prefix_cache_off(cfg, cuda_params)
