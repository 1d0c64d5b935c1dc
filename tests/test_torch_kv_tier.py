"""KV-cache migration and the cluster KV tier in the port
(``ray_tpu_torch.inference``), on the CPU, on ``LlamaConfig.tiny()`` in
f32: ports of the cluster-free and in-process cases of
``tests/test_kv_tier.py``, the port's KV payload against the JAX engine's,
and the port's own refusals.

Layers, cheapest first: the seeded ``KvTierFaultPlan``; the block
manager's spill-vs-drop books; the daemon-less tier registry and its
integrity gate; the daemon registry's popularity eviction (on a stub); the
router's tier directory; engine and server roundtrips (prefill write-back
faulted in by another server, the counted fallback ladder, drain with
migration, the model namespace, the replay shortfall). Every roundtrip
asserts that the migration or the tier was used — prefix-hit tokens and
the tier counters — not only that the tokens match.

Against the JAX package, on the same params (``params_from_jax``): the
port's ``prefill_kv`` payload holds the same tokens and block size as the
JAX engine's and its ``kv`` agrees within f32 ``rtol=atol=1e-5`` (another
summation order in every matmul); the JAX payload imported into the port
gives the port's own plain stream byte for byte, and the JAX engine's
stream token for token; ``_chain_digest`` is one function in both.
"""

import inspect
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.inference.engine import EngineConfig as JaxEngineConfig
from ray_tpu.inference.engine import InferenceEngine as JaxEngine
from ray_tpu.inference.engine import _model_kv_namespace as jax_namespace
from ray_tpu.inference.kv_cache import _chain_digest as jax_chain_digest
from ray_tpu.models import llama as jl
from ray_tpu_torch.inference import EngineConfig, InferenceEngine, LLMServer
from ray_tpu_torch.inference import kv_transfer
from ray_tpu_torch.inference.engine import KvMigrationHandoff, _model_kv_namespace
from ray_tpu_torch.inference.kv_cache import PagedBlockManager, _chain_digest
from ray_tpu_torch.inference.kv_transfer import KV_MIGRATION_MARKER
from ray_tpu_torch.inference.model_runner import PagedModelRunner
from ray_tpu_torch.models.llama import LlamaConfig, init_params, params_from_jax
from ray_tpu_torch.observability.rpc_metrics import (
    KV_TIER_FALLBACKS,
    KV_TIER_HITS,
    KV_TIER_PUBLISHES,
    STREAM_RESUME_REPLAY_TOKENS,
)
from ray_tpu_torch.util.chaos import KvTierFaultPlan, ReplicaFaultPlan, derive_plan_seed

torch.set_num_threads(1)

#: 24 tokens = 3 full blocks at block_size 8
SHARED = [12, 7, 3, 9, 1, 5, 2, 8] * 3


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 0, device="cpu")


def _ec(**overrides):
    kw = dict(
        num_blocks=64, block_size=8, prefill_buckets=(8, 32),
        decode_buckets=(1, 4), max_decode_batch=4, max_new_tokens_default=8,
        warmup=False, kv_transfer_enabled=True, kv_tier_enabled=True,
    )
    kw.update(overrides)
    return EngineConfig(**kw)


def _server(cfg, params, **overrides):
    return LLMServer(cfg, _ec(**overrides), params=params, export_metrics=False, device="cpu")


@pytest.fixture(autouse=True)
def _clean_tier():
    """Every test ends with an empty local tier and no surgically-armed
    plan — ``_LOCAL_TIER`` is process-global state."""
    yield
    with kv_transfer._LOCAL_TIER_LOCK:
        kv_transfer._LOCAL_TIER.clear()
    kv_transfer.testing_tier_plan = None


def _digests(tokens, bs=8):
    """Full-block chain digests of ``tokens`` (the tier's key space)."""
    out, prev = [], b""
    for end in range(bs, len(tokens) + 1, bs):
        prev = _chain_digest(prev, tokens[end - bs : end])
        out.append(prev)
    return out


def _collect(gen):
    """Flatten LLMServer.generate's TokenChunk bursts, as the router does."""
    return [t for chunk in gen for t in chunk]


def _fallbacks():
    return sum(kv_transfer.migration_metrics()["fallbacks"]._values.values())


# ---------------------------------------------------------------------------
# KvTierFaultPlan


def test_kv_tier_fault_plan_grammar_and_determinism():
    with pytest.raises(ValueError):
        KvTierFaultPlan("missing_block", 1)  # no prob
    with pytest.raises(ValueError):
        KvTierFaultPlan("explode:1.0", 1)  # unknown mode
    phases = ["fault_in"] * 6 + ["migration"] * 4 + ["fault_in"] * 6
    p1 = KvTierFaultPlan("corrupt_block:0.5:0:99", 77)
    p2 = KvTierFaultPlan("corrupt_block:0.5:0:99", 77)
    s1 = [p1.consult(ph) for ph in phases]
    assert s1 == [p2.consult(ph) for ph in phases]
    assert p1.consults == len(phases)
    assert all(v is None for v, ph in zip(s1, phases) if ph == "migration")
    p = KvTierFaultPlan("missing_block:1.0:2:99", 3)
    got = [p.consult("fault_in") for _ in range(4)]
    assert got[:2] == [None, None] and got[2] == ("missing_block", 2.0)
    p = KvTierFaultPlan("missing_block:1.0", 3)
    fired = [p.consult("fault_in") for _ in range(5)]
    assert fired.count(("missing_block", 0.0)) == 1 and p.injections == 1
    p = KvTierFaultPlan("kill_mid_migration:1.0", 9)
    assert p.consult("fault_in") is None
    assert p.consult("migration") == ("kill_mid_migration", 0.0)


def test_kv_tier_plan_derives_from_master_chaos_seed():
    master = 20260806
    seed = derive_plan_seed(master, "kv_tier")
    assert seed == derive_plan_seed(master, "kv_tier")
    assert seed != derive_plan_seed(master, "replica")
    a = KvTierFaultPlan("missing_block:0.3:0:99", seed)
    b = KvTierFaultPlan("missing_block:0.3:0:99", seed)
    phases = ["fault_in"] * 32
    assert [a.consult(p) for p in phases] == [b.consult(p) for p in phases]


# ---------------------------------------------------------------------------
# spill-vs-drop books


def _balanced(mgr):
    assert (mgr.prefix_evictions_total
            == mgr.prefix_spilled_total + mgr.prefix_dropped_total)


def test_spill_vs_drop_books_balance():
    """Every evicted indexed block is exactly one of spilled or dropped,
    the hook only sees unreferenced blocks, popularity decides."""
    T = [31, 4, 44, 18] * 2
    offered = []
    mgr = PagedBlockManager(8, 4, prefix_cache_enabled=True)

    def hook(digest, blk, hits):
        offered.append((digest, blk, hits, mgr._ref.get(blk, 0)))
        return hits > 0

    mgr.set_spill_hook(hook)
    assert mgr.grow_to("a", 8)
    assert mgr.register_prefix("a", T) == 2
    mgr.free("a")
    cached, cow = mgr.acquire_prefix("b", T + [99])
    assert cached == 8 and not cow
    mgr.free("b")
    assert mgr.grow_to("c", 28)
    _balanced(mgr)
    assert mgr.prefix_evictions_total == 2
    assert mgr.prefix_spilled_total == 2 and mgr.prefix_dropped_total == 0
    assert [h for _, _, h, _ in offered] == [1, 1]
    U = list(range(100, 128))
    assert mgr.register_prefix("c", U) == 7
    mgr.free("c")
    assert mgr.grow_to("d", 28)
    _balanced(mgr)
    assert mgr.prefix_evictions_total == 9 and mgr.prefix_dropped_total == 7
    mgr.free("d")
    assert all(ref == 0 for _, _, _, ref in offered), offered
    st = mgr.prefix_stats()
    assert st["spilled_total"] == 2 and st["dropped_total"] == 7


def test_spill_hook_cap_eviction_and_broken_hook():
    seen = []
    mgr = PagedBlockManager(8, 4, prefix_cache_enabled=True, prefix_cache_max_blocks=1)
    mgr.set_spill_hook(lambda d, b, h: seen.append(b) or True)
    assert mgr.grow_to("a", 8)
    assert mgr.register_prefix("a", [1, 2, 3, 4]) == 1
    mgr.free("a")
    assert mgr.grow_to("b", 4)
    assert mgr.register_prefix("b", [9, 9, 9, 9]) == 1
    _balanced(mgr)
    assert mgr.prefix_evictions_total == 1 and mgr.prefix_spilled_total == 1
    assert len(seen) == 1
    mgr.free("b")
    mgr2 = PagedBlockManager(4, 4, prefix_cache_enabled=True)

    def broken(d, b, h):
        raise RuntimeError("policy crashed")

    mgr2.set_spill_hook(broken)
    assert mgr2.grow_to("a", 4)
    assert mgr2.register_prefix("a", [5, 6, 7, 8]) == 1
    mgr2.free("a")
    assert mgr2.grow_to("b", 12)
    _balanced(mgr2)
    assert mgr2.prefix_dropped_total == 1 and mgr2.prefix_spilled_total == 0


# ---------------------------------------------------------------------------
# daemon-less tier registry + integrity gate


def test_local_tier_roundtrip_delete_and_cap():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    kv = np.arange(2 * 2 * 1 * 8 * 2 * 16, dtype=np.float32).reshape(2, 2, 1, 8, 2, 16)
    d1, d2, d3 = _digests([1] * 8 + [2] * 8 + [3] * 8)
    desc = kv_transfer.tier_publish(d1, kv, 8)
    assert desc is not None and desc["tier_digest"] == d1.hex()
    assert d1.hex() in kv_transfer.tier_list()
    f = kv_transfer.tier_fetch(desc)
    try:
        assert np.array_equal(f.array, kv)
    finally:
        f.close()
    kv_transfer.tier_fetch(desc).close()  # tier reads keep the source
    kv_transfer.tier_delete(d1.hex(), desc=desc)
    assert d1.hex() not in kv_transfer.tier_list()
    old_cap = GLOBAL_CONFIG.kv_tier_max_entries
    GLOBAL_CONFIG.kv_tier_max_entries = 2
    try:
        for d in (d1, d2, d3):
            assert kv_transfer.tier_publish(d, kv, 8) is not None
        entries = kv_transfer.tier_list()
        assert d1.hex() not in entries
        assert d2.hex() in entries and d3.hex() in entries
    finally:
        GLOBAL_CONFIG.kv_tier_max_entries = old_cap


def test_daemon_tier_popularity_eviction_hot_prefix_outlives_cold():
    """The port's NodeDaemon registry (on a stub: no cluster, no sockets)
    evicts by (hit count, recency): a hot prefix outlives colder newer
    entries, and TTL still dominates."""
    import asyncio
    from collections import OrderedDict

    from ray_tpu_torch.core.config import GLOBAL_CONFIG
    from ray_tpu_torch.core.node_daemon import NodeDaemon

    class _Stub:
        class store:  # noqa: N801 — _kv_tier_drop_locked calls .delete
            @staticmethod
            def delete(oid):
                pass

    stub = _Stub()
    stub._kv_tier = OrderedDict()
    stub._last_kv_tier_sweep = 0.0
    stub._kv_tier_sweep = NodeDaemon._kv_tier_sweep.__get__(stub)
    stub._kv_tier_drop_locked = NodeDaemon._kv_tier_drop_locked.__get__(stub)

    def put(d):
        stub._last_kv_tier_sweep = -1e9
        assert asyncio.run(NodeDaemon.d_kv_tier_put(stub, {"digest": d, "desc": {"d": d}}, None))

    def get(d):
        return asyncio.run(NodeDaemon.d_kv_tier_get(stub, {"digest": d}, None))

    old_cap = GLOBAL_CONFIG.kv_tier_max_entries
    GLOBAL_CONFIG.kv_tier_max_entries = 3
    try:
        for d in ("hot", "cold1", "cold2"):
            put(d)
        for _ in range(4):
            assert get("hot") == {"d": "hot"}
        put("new1")
        assert set(stub._kv_tier) == {"hot", "cold2", "new1"}
        put("new2")
        assert set(stub._kv_tier) == {"hot", "new1", "new2"}
        put("new1")
        assert stub._kv_tier["new1"]["hits"] == 1
        stub._kv_tier["hot"]["expiry"] = -1.0
        stub._last_kv_tier_sweep = -1e9
        NodeDaemon._kv_tier_sweep(stub)
        assert "hot" not in stub._kv_tier and get("hot") is None
    finally:
        GLOBAL_CONFIG.kv_tier_max_entries = old_cap


def test_tier_fetch_chaos_modes_hit_the_integrity_gate():
    kv = np.ones((2, 2, 1, 8, 2, 16), dtype=np.float32)
    (d1,) = _digests([4] * 8)
    desc = kv_transfer.tier_publish(d1, kv, 8)
    assert desc is not None
    kv_transfer.testing_tier_plan = KvTierFaultPlan("corrupt_block:1.0", 5)
    with pytest.raises(kv_transfer.KvTransferError, match="digest"):
        kv_transfer.tier_fetch(desc)
    kv_transfer.testing_tier_plan = KvTierFaultPlan("missing_block:1.0", 5)
    with pytest.raises(kv_transfer.KvTransferError, match="missing"):
        kv_transfer.tier_fetch(desc)
    assert d1.hex() in kv_transfer.tier_list()
    kv_transfer.testing_tier_plan = KvTierFaultPlan("stale_advert:1.0", 5)
    with pytest.raises(kv_transfer.KvTransferError):
        kv_transfer.tier_fetch(desc)
    assert d1.hex() not in kv_transfer.tier_list()
    kv_transfer.tier_fetch(kv_transfer.tier_publish(d1, kv, 8)).close()


# ---------------------------------------------------------------------------
# router tier directory


class _FakeHandle:
    def __init__(self, aid):
        self.actor_id = aid


def _routing_set(entries, stamp):
    return [
        (h, (), {"stats": {"prefix_digest": [], "kv_tier": adv}, "age_s": 0.0, "stamp": stamp})
        for h, adv in entries
    ]


def test_router_tier_retraction_and_dead_holder_ttl():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG
    from ray_tpu_torch.observability.rpc_metrics import KV_TIER_RETRACTIONS
    from ray_tpu_torch.serve.router import Router

    r = Router(None, "t")
    a = _FakeHandle("actor-a")
    d1, d2 = _digests([7] * 8 + [8] * 8)
    desc = {"block_size": 8}
    before = KV_TIER_RETRACTIONS._values.get((), 0.0)
    r._apply(_routing_set([(a, {d1.hex(): desc, d2.hex(): desc})], 1))
    assert set(r._tier_dir) == {d1.hex(), d2.hex()}
    r._apply(_routing_set([(a, {d1.hex(): desc})], 2))
    assert set(r._tier_dir) == {d1.hex()}
    assert KV_TIER_RETRACTIONS._values.get((), 0.0) - before == 1
    r._apply([])  # holder death is not retraction
    assert set(r._tier_dir) == {d1.hex()}
    old_ttl = GLOBAL_CONFIG.kv_tier_advert_ttl_s
    GLOBAL_CONFIG.kv_tier_advert_ttl_s = 0.0
    try:
        r._apply([])
        assert not r._tier_dir
    finally:
        GLOBAL_CONFIG.kv_tier_advert_ttl_s = old_ttl


def test_router_tier_attach_matches_consecutive_chain():
    from ray_tpu_torch.serve.router import Router

    r = Router(None, "t")
    a = _FakeHandle("actor-a")
    prompt = SHARED + [77]
    d1, d2, d3 = _digests(prompt)
    desc = {"block_size": 8}
    assert r._tier_attach(prompt) is None
    r._apply(_routing_set([(a, {d1.hex(): desc, d3.hex(): desc})], 1))
    spec = r._tier_attach(prompt)
    assert spec["tokens"] == 8 and [b[0] for b in spec["blocks"]] == [d1.hex()]
    r._apply(_routing_set([(a, {d.hex(): desc for d in (d1, d2, d3)})], 2))
    spec = r._tier_attach(prompt)
    assert spec["tokens"] == 24
    assert [b[0] for b in spec["blocks"]] == [d1.hex(), d2.hex(), d3.hex()]
    assert r._tier_attach(prompt[:8]) is None


# ---------------------------------------------------------------------------
# engine write-back -> cross-server fault-in


def test_tier_fault_in_across_servers_byte_exact(cfg, params):
    """Engine A's prefill write-back lands in the (local) tier; server B
    faults it in from a router-built spec and produces the byte-exact
    stream with the prefix provably warm. Then the armed ladder
    (missing_block) and corrupt_block: counted fallback, byte-exact."""
    prompt = SHARED + [77]
    ref = InferenceEngine(cfg, params, _ec(kv_tier_enabled=False)).start()
    try:
        expected = list(ref.generate(prompt, max_new_tokens=6, temperature=0.7, seed=3))
    finally:
        ref.stop()
    pubs_before = KV_TIER_PUBLISHES._values.get(("prefill",), 0.0)
    a = InferenceEngine(cfg, params, _ec()).start()
    try:
        assert list(a.generate(prompt, max_new_tokens=6, temperature=0.7, seed=3)) == expected
        assert a.flush_tier_writebacks()
        adverts = a.routing_stats()["kv_tier"]
        chain = _digests(prompt)
        assert all(d.hex() in adverts for d in chain), list(adverts)
        assert KV_TIER_PUBLISHES._values.get(("prefill",), 0.0) - pubs_before >= 3
        spec = {"blocks": [[d.hex(), adverts[d.hex()]] for d in chain], "tokens": 24}
    finally:
        a.stop()
    hits_before = KV_TIER_HITS._values.get((), 0.0)
    b = _server(cfg, params)
    try:
        out_b = _collect(b.generate({"prompt": prompt, "max_new_tokens": 6,
                                     "temperature": 0.7, "seed": 3, "kv_tier": dict(spec)}))
        assert out_b == expected
        assert KV_TIER_HITS._values.get((), 0.0) - hits_before == 3
        assert b.engine.blocks.prefix_tokens_saved_total == 24
    finally:
        b.engine.stop()
    for mode, seed in (("missing_block", 13), ("corrupt_block", 17)):
        fb_before = sum(KV_TIER_FALLBACKS._values.values())
        c = _server(cfg, params)
        try:
            c.testing_arm_kv_tier_chaos(f"{mode}:1.0:0:99", seed)
            out_c = _collect(c.generate({"prompt": prompt, "max_new_tokens": 6,
                                         "temperature": 0.7, "seed": 3, "kv_tier": dict(spec)}))
            assert out_c == expected
            assert sum(KV_TIER_FALLBACKS._values.values()) > fb_before
            assert c.engine.blocks.prefix_tokens_saved_total == 0
        finally:
            kv_transfer.testing_tier_plan = None
            c.engine.stop()


def test_tier_adverts_survive_concurrent_publish_and_gossip(cfg, params):
    """The publisher thread moves and evicts adverts while the gossip
    snapshots them: with a short switch interval and four readers, no
    snapshot fails, the queue drains, and the adverts end at the cap."""
    import sys
    import threading

    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    eng = InferenceEngine(cfg, params, _ec()).start()
    kv = np.zeros((2, 2, 1, 8, 2, 16), dtype=np.float32)
    digests = _digests(list(range(8 * 200)))
    errors, stop = [], threading.Event()

    def gossip():
        while not stop.is_set():
            try:
                eng.routing_stats()
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    readers = [threading.Thread(target=gossip) for _ in range(4)]
    try:
        for th in readers:
            th.start()
        for d in digests:
            eng._tier_enqueue(d, kv, "decode")
            while eng._tier_pub_q.full():
                time.sleep(0.001)
        assert eng.flush_tier_writebacks(60.0)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for th in readers:
            th.join(timeout=30)
        eng.stop()
    assert not any(th.is_alive() for th in readers)
    assert not errors, errors[:3]
    adverts = eng.routing_stats()["kv_tier"]
    cap = GLOBAL_CONFIG.kv_tier_max_adverts
    assert list(adverts) == [d.hex() for d in digests[-cap:]]


# ---------------------------------------------------------------------------
# live decode migration (drain flushes prompt + generated)


def test_drain_migration_flushes_full_kv_and_survivor_resumes(cfg, params):
    """``begin_drain(migrate=True)`` mid-decode: the request fails with
    the resumable marker, its FULL written KV is tier-resident, and a
    survivor resumes the stream byte-exact with the generated prefix warm."""
    max_new = 20
    ref = InferenceEngine(cfg, params, _ec(kv_tier_enabled=False)).start()
    try:
        expected = list(ref.generate(SHARED, max_new_tokens=max_new, temperature=0.7, seed=11))
    finally:
        ref.stop()
    dec_before = KV_TIER_PUBLISHES._values.get(("decode",), 0.0)
    a = InferenceEngine(cfg, params, _ec()).start()
    delivered = []
    try:
        rid = a.submit(SHARED, max_new_tokens=max_new, temperature=0.7, seed=11)
        it = a.tokens(rid, timeout=120)
        delivered.append(next(it))
        a.testing_fault_plan = ReplicaFaultPlan("stall:1.0:0.25:9999", 1)
        with pytest.raises(KvMigrationHandoff, match=KV_MIGRATION_MARKER):
            for t in it:
                delivered.append(t)
                if len(delivered) == 9:
                    a.begin_drain(migrate=True)
        d = len(delivered)
        assert 9 <= d < max_new and delivered == expected[:d]
        extended = SHARED + delivered
        assert a.flush_tier_writebacks()
        adverts = a.routing_stats()["kv_tier"]
        chain = _digests(extended[: len(extended) - 1])
        assert len(chain) >= 4  # at least one generated-token block
        assert all(dg.hex() in adverts for dg in chain)
        assert KV_TIER_PUBLISHES._values.get(("decode",), 0.0) > dec_before
        assert a.blocks.used_blocks == 0
    finally:
        a.testing_fault_plan = None
        a.stop()
    b = _server(cfg, params)
    hits_before = KV_TIER_HITS._values.get((), 0.0)
    try:
        spec = {"blocks": [[dg.hex(), adverts[dg.hex()]] for dg in chain],
                "tokens": len(chain) * 8}
        out = _collect(b.generate({"prompt": extended, "max_new_tokens": max_new,
                                   "temperature": 0.7, "seed": 11, "resume_from": d,
                                   "kv_tier": spec, "request_id": "mig-resume"}))
        assert [tok for _, tok in out] == expected[d:]
        assert [seq for seq, _ in out] == list(range(d, max_new))
        assert KV_TIER_HITS._values.get((), 0.0) - hits_before == len(chain)
        assert b.engine.blocks.prefix_tokens_saved_total >= len(chain) * 8 - 8
    finally:
        b.engine.stop()


def test_migrate_mid_prefill_publishes_only_written_blocks(cfg, params):
    """A drain migration landing mid-prefill flushes only the positions
    chunked prefill actually wrote, never allocated-but-unwritten blocks."""
    prompt = SHARED + [41, 42, 43, 44, 45, 46, 47, 48]  # 32 = 4 blocks
    eng = InferenceEngine(cfg, params, _ec(prefill_buckets=(8,)))
    mig_before = KV_TIER_PUBLISHES._values.get(("migrate",), 0.0)
    try:
        rid = eng.submit(prompt, max_new_tokens=4, temperature=0.0)
        assert eng.step()  # one 8-token chunk: prefill_pos=8, not done
        eng._migrate_on_drain = True
        eng._migrate_inflight()
        adverts = eng.routing_stats()["kv_tier"]
        chain = _digests(prompt)
        assert chain[0].hex() in adverts, list(adverts)
        assert all(dg.hex() not in adverts for dg in chain[1:]), list(adverts)
        # the one written block went at the drain, under trigger "migrate"
        assert KV_TIER_PUBLISHES._values.get(("migrate",), 0.0) == mig_before + 1
        with pytest.raises(Exception, match=KV_MIGRATION_MARKER):
            list(eng.tokens(rid, timeout=10))
    finally:
        eng.stop()


_NS_SCRIPT = (
    "import torch; torch.set_num_threads(1)\n"
    "from ray_tpu_torch.inference.engine import _model_kv_namespace\n"
    "from ray_tpu_torch.models.llama import LlamaConfig, init_params\n"
    "cfg = LlamaConfig.tiny()\n"
    "print(_model_kv_namespace(cfg, init_params(cfg, 0, device='cpu'), 'float32'))\n"
)


def test_tier_namespace_scopes_host_dirs(cfg, params, tmp_path):
    """The namespace folds in the port's host directory (``TMPDIR``): a
    process of the same deployment (which inherits ``TMPDIR``) computes the
    same one, and a checkout run with another ``TMPDIR`` another, so the
    two never share a tier key or a shared-memory segment name."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    other = tmp_path / "other"
    other.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", _NS_SCRIPT], env=e, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for e in (env, dict(env, TMPDIR=str(other)))]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    same, elsewhere = (out.strip() for out, _ in outs)
    here = _model_kv_namespace(cfg, params, "float32")
    assert same == here
    assert elsewhere and elsewhere != here


def test_tier_namespace_scopes_models(cfg, params):
    """Namespaces are deterministic for the same weights, disjoint for
    different weights (one value changed is enough) and for the reference
    package, enforced at recovery adoption and at the fault-in consumer."""
    params2 = init_params(cfg, 1, device="cpu")
    a = InferenceEngine(cfg, params, _ec())
    b = InferenceEngine(cfg, params2, _ec())
    same = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"), _ec())
    assert a._tier_ns and a._tier_ns == same._tier_ns
    assert a._tier_ns != b._tier_ns
    tweaked = init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        tweaked.layers[1].w_down[5, 7] += 1.0  # not among any leaf's first values
    assert _model_kv_namespace(cfg, tweaked, "float32") != a._tier_ns
    assert _model_kv_namespace(cfg, params, "bfloat16") != a._tier_ns
    # the reference's namespace of the same weights is another key
    jp = jax.tree_util.tree_map(np.asarray, jl.init_params(jl.LlamaConfig.tiny(),
                                                          jax.random.PRNGKey(0)))
    ported = init_params(cfg, 0, device="cpu")
    ported.load_state_dict(params_from_jax(jp))
    assert _model_kv_namespace(cfg, ported, "float32") != jax_namespace(
        jl.LlamaConfig.tiny(), jp)

    kv = np.ones((2, 2, 1, 8, 2, 16), dtype=np.float32)
    (d1,) = _digests([4] * 8)
    da = kv_transfer.tier_publish(d1, kv, 8, ns=a._tier_ns)
    db = kv_transfer.tier_publish(d1, kv, 8, ns=b._tier_ns)
    assert da["tier_ns"] == a._tier_ns and db["tier_ns"] == b._tier_ns
    raw = kv_transfer.tier_list()
    assert f"{a._tier_ns}:{d1.hex()}" in raw and f"{b._tier_ns}:{d1.hex()}" in raw
    assert not kv_transfer.tier_list(ns="")
    a._tier_recover()
    assert a._tier_adverts[d1.hex()]["tier_ns"] == a._tier_ns
    assert all(v["tier_ns"] == a._tier_ns for v in a._tier_adverts.values())

    ref = InferenceEngine(cfg, params, _ec(kv_tier_enabled=False)).start()
    try:
        expected = list(ref.generate(SHARED + [77], max_new_tokens=4, temperature=0.7, seed=3))
    finally:
        ref.stop()
    srv = _server(cfg, params)
    try:
        fb_before = KV_TIER_FALLBACKS._values.get(("namespace",), 0.0)
        out = _collect(srv.generate({"prompt": SHARED + [77], "max_new_tokens": 4,
                                     "temperature": 0.7, "seed": 3,
                                     "kv_tier": {"blocks": [[d1.hex(), db]], "tokens": 8}}))
        assert out == expected
        assert KV_TIER_FALLBACKS._values.get(("namespace",), 0.0) - fb_before == 1
        assert srv.engine.blocks.prefix_tokens_saved_total == 0
    finally:
        srv.engine.stop()


def test_covered_but_failed_fault_in_books_replay_shortfall(cfg, params):
    """A covered chain whose fault-in fails books the delivered-region
    shortfall (tokens - (P - seq) = 32 - 24 = 8) into the replay counter."""
    max_new, seq = 20, 9
    ref = InferenceEngine(cfg, params, _ec(kv_tier_enabled=False)).start()
    try:
        expected = list(ref.generate(SHARED, max_new_tokens=max_new, temperature=0.7, seed=11))
    finally:
        ref.stop()
    extended = SHARED + expected[:seq]
    a = InferenceEngine(cfg, params, _ec()).start()
    try:
        list(a.generate(extended, max_new_tokens=1, temperature=0.7, seed=2))
        assert a.flush_tier_writebacks()
        adverts = a.routing_stats()["kv_tier"]
        chain = _digests(extended)
        assert all(dg.hex() in adverts for dg in chain)
        spec = {"blocks": [[dg.hex(), adverts[dg.hex()]] for dg in chain],
                "tokens": len(chain) * 8}
    finally:
        a.stop()
    assert spec["tokens"] >= len(extended) - 8
    b = _server(cfg, params)
    try:
        b.testing_arm_kv_tier_chaos("missing_block:1.0:0:99", 13)
        before = STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0)
        out = _collect(b.generate({"prompt": extended, "max_new_tokens": max_new,
                                   "temperature": 0.7, "seed": 11, "resume_from": seq,
                                   "kv_tier": dict(spec), "request_id": "rs-shortfall"}))
        assert [tok for _, tok in out] == expected[seq:]
        assert STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0) - before == 8
    finally:
        kv_transfer.testing_tier_plan = None
        b.engine.stop()


# ---------------------------------------------------------------------------
# the port's payload and its refusals


def test_runner_payload_names_its_type_and_scatter_refuses_another():
    """``gather_blocks`` returns the runner's host type (bf16 as ``uint16``
    bits), a bf16 gather/scatter roundtrip is byte-exact, and
    ``scatter_blocks`` refuses bf16 bits for an f32 cache and f32 values
    for a bf16 cache instead of converting them."""
    runners = {}
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        cfg = LlamaConfig.tiny(dtype=dt)
        r = PagedModelRunner(cfg, init_params(cfg, 0, device="cpu"), num_blocks=16,
                             block_size=8, prefill_buckets=(8,), decode_buckets=(1,))
        assert r.kv_dtype == name
        g = torch.Generator().manual_seed(3)
        with torch.inference_mode():  # the cache is made under it
            for key in ("k", "v"):
                r.cache[key].copy_(torch.randn(r.cache[key].shape, generator=g).to(dt))
        runners[name] = r
    bf, f32 = runners["bfloat16"], runners["float32"]
    assert bf.kv_host_dtype == np.uint16 and f32.kv_host_dtype == np.float32
    kv = bf.gather_blocks([3, 5, 7])
    assert kv.dtype == np.uint16 and kv.shape == (2, 2, 3, 8, 2, 16)
    bf.scatter_blocks([9, 10, 11], kv)
    assert torch.equal(bf.cache["k"][:, [9, 10, 11]], bf.cache["k"][:, [3, 5, 7]])
    assert torch.equal(bf.cache["v"][:, [9, 10, 11]], bf.cache["v"][:, [3, 5, 7]])
    before = f32.cache["k"].clone()
    with pytest.raises(TypeError, match="uint16"):
        f32.scatter_blocks([1, 2, 3], kv)
    with pytest.raises(TypeError, match="float32"):
        bf.scatter_blocks([1], f32.gather_blocks([1]))
    assert torch.equal(f32.cache["k"], before)


def test_import_refuses_a_descriptor_of_another_type_or_digest(cfg, params):
    """A handoff descriptor whose host type, block size or digest is wrong is
    refused and counted as a fallback, and the stream still equals the
    plain one with nothing imported; the right descriptor is used."""
    prompt = SHARED + [5, 6, 7]
    req = {"prompt": prompt, "max_new_tokens": 6, "temperature": 0.8, "seed": 4}
    a = _server(cfg, params, kv_tier_enabled=False)
    plain = _server(cfg, params, kv_tier_enabled=False)
    try:
        desc = a.prefill_export(req)
        assert desc["dtype"] == "float32"
        assert desc["tokens"] == 24 and desc["inline"] is not None
        expected = plain(req)["tokens"]
        fb = kv_transfer.migration_metrics()["fallbacks"]._values
        for bad, reason in (({"dtype": "uint16"}, "shape_mismatch"),
                            ({"block_size": 16}, "shape_mismatch"),
                            ({"crc32": desc["crc32"] ^ 0xFF}, "transfer")):
            b = _server(cfg, params, kv_tier_enabled=False)
            try:
                before = fb.get((reason,), 0.0)
                assert b({**req, "kv_import": {**desc, **bad}})["tokens"] == expected
                assert fb.get((reason,), 0.0) - before == 1
                assert b.engine.blocks.prefix_tokens_saved_total == 0
            finally:
                b.engine.stop()
        transfers = kv_transfer.migration_metrics()["transfers"]._values.get((), 0.0)
        before_fb = _fallbacks()
        b = _server(cfg, params, kv_tier_enabled=False)
        try:
            assert b({**req, "kv_import": desc})["tokens"] == expected
            assert b.engine.blocks.prefix_tokens_saved_total == 24
            assert b.engine.stats()["prefix_cache"]["hits_total"] == 1
        finally:
            b.engine.stop()
        assert kv_transfer.migration_metrics()["transfers"]._values.get((), 0.0) - transfers == 1
        assert _fallbacks() == before_fb
    finally:
        a.engine.stop()
        plain.engine.stop()


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.fixture(scope="module")
def jax_pair():
    jcfg, tcfg = jl.LlamaConfig.tiny(), LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = init_params(tcfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jcfg, jp, tcfg, model


#: the JAX engine's knobs (the port's EngineConfig takes the same)
ENGINE = dict(num_blocks=64, block_size=8, prefill_buckets=(8, 32), decode_buckets=(1, 4),
              max_decode_batch=4, warmup=False, kv_transfer_enabled=True)
#: a prompt that is not a block multiple (3 full blocks and a tail of 5)
PROMPT = [int(x) for x in np.random.RandomState(5).randint(1, 256, size=29)]


def test_prefill_kv_payload_matches_jax_engine(jax_pair):
    jcfg, jp, tcfg, model = jax_pair
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ENGINE)).start()
    teng = InferenceEngine(tcfg, model, EngineConfig(**ENGINE)).start()
    try:
        jpay, tpay = jeng.prefill_kv(PROMPT), teng.prefill_kv(PROMPT)
    finally:
        jeng.stop()
        teng.stop()
    assert tpay["tokens"] == jpay["tokens"] == PROMPT[:24]
    assert tpay["block_size"] == jpay["block_size"] == 8
    assert tpay["dtype"] == "float32" and tpay["kv"].dtype == np.float32
    jkv = np.asarray(jpay["kv"])
    assert tpay["kv"].shape == jkv.shape == (2, 2, 3, 8, 2, 16)
    np.testing.assert_allclose(tpay["kv"], jkv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "seed": 5}], ids=["greedy", "seeded"])
def test_jax_payload_imports_into_the_port(jax_pair, sampling):
    """The JAX engine's payload scattered into the port's engine gives the
    port's own plain stream byte for byte (the import is used: a prefix
    hit over 24 of the 29 prompt tokens) and the JAX engine's stream."""
    jcfg, jp, tcfg, model = jax_pair
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ENGINE)).start()
    try:
        payload = jeng.prefill_kv(PROMPT)
        jstream = list(jeng.generate(PROMPT, max_new_tokens=10, **sampling))
    finally:
        jeng.stop()
    plain = InferenceEngine(tcfg, model, EngineConfig(**ENGINE)).start()
    teng = InferenceEngine(tcfg, model, EngineConfig(**ENGINE)).start()
    try:
        want = list(plain.generate(PROMPT, max_new_tokens=10, **sampling))
        kv = np.asarray(payload["kv"], dtype=np.float32)
        assert teng.import_kv_blocks(payload["tokens"], kv) == 24
        got = list(teng.generate(PROMPT, max_new_tokens=10, **sampling))
        saved = teng.blocks.prefix_tokens_saved_total
    finally:
        plain.stop()
        teng.stop()
    assert saved == 24
    assert got == want
    assert got == jstream


def test_chain_digest_equal_across_packages():
    rs = np.random.RandomState(9)
    prev_j = prev_t = b""
    for _ in range(6):
        block = [int(x) for x in rs.randint(0, 32000, size=16)]
        prev_j, prev_t = jax_chain_digest(prev_j, block), _chain_digest(prev_t, block)
        assert prev_t == prev_j and len(prev_t) == 16


def test_submit_takes_the_jax_engines_keywords():
    """``submit`` (``prefill_only`` included) and ``prefill_kv`` /
    ``import_kv_blocks`` take the JAX engine's parameters, in its order."""
    for name in ("submit", "generate", "prefill_kv", "import_kv_blocks", "begin_drain"):
        ours = inspect.signature(getattr(InferenceEngine, name))
        ref = inspect.signature(getattr(JaxEngine, name))
        assert [(p.name, p.kind, p.default) for p in ours.parameters.values()] == \
            [(p.name, p.kind, p.default) for p in ref.parameters.values()], name
