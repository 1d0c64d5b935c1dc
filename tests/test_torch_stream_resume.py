"""Resumable LLM streams on the port (``ray_tpu_torch``): ports of the
cluster-free cases of ``tests/test_stream_resume.py``, run on the CPU on
``LlamaConfig.tiny()`` in f32.

Three layers under test, as in the reference:

* deterministic continuation — a request resubmitted as
  ``prompt + generated[:k]`` continues the identical stream on any engine
  with the same params (plain or speculative, across preemption);
* seq-numbered streaming — ``LLMServer.generate`` in ``resume_from`` mode
  yields ``(seq, token)`` pairs, and ``SeqGate`` admits each seq once;
* seeded replica chaos — ``ReplicaFaultPlan`` (``kill_mid_decode``,
  ``stall``) consulted by the engine's step loop. A kill runs only in a
  child process (``tools/chaos_stream.py``), never in pytest's own.

Against the JAX package: the fault plan's consult schedule and seeds equal
``ray_tpu.util.chaos``'s for the same spec and seed, and the port's
``LLMServer`` gives the same ``(seq, token)`` streams and ``routing_stats``
keys as ``ray_tpu.inference.serve_llm.LLMServer`` on the same params (the
tiny f32 config whose engine ``test_engine_matches_jax_engine`` holds token
for token). Within the port every comparison is byte-exact.
"""

import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.inference.serve_llm import LLMServer as JaxLLMServer
from ray_tpu.models import llama as jl
from ray_tpu.util import chaos as jax_chaos
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.streaming import SeqGate, TokenChunk
from ray_tpu_torch.inference import EngineConfig, InferenceEngine, LLMServer
from ray_tpu_torch.models.llama import LlamaConfig, init_params, params_from_jax
from ray_tpu_torch.tools.chaos_stream import stream_in_child
from ray_tpu_torch.util import chaos

torch.set_num_threads(1)

#: the kill plan of the reference's chaos cluster
CHAOS_SPEC, CHAOS_SEED = "kill_mid_decode:1.0:6", 20260804
ENGINE = dict(num_blocks=64, block_size=8, prefill_buckets=(8, 32), decode_buckets=(1, 4),
              max_decode_batch=4, max_new_tokens_default=8, warmup=False)


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 0, device="cpu")


def _engine(cfg, params, **overrides):
    return InferenceEngine(cfg, params, EngineConfig(**{**ENGINE, **overrides})).start()


def _server(cfg, params, **overrides):
    return LLMServer(cfg, EngineConfig(**{**ENGINE, **overrides}), params=params,
                     export_metrics=False, device="cpu")


def _flat(chunks):
    """A stream of bursts flattened, as the serve router does."""
    return [item for chunk in chunks for item in chunk]


# ---------------------------------------------------------------------------
# units: SeqGate + ReplicaFaultPlan


def test_seq_gate_admits_once_suppresses_duplicates_and_fails_gaps():
    g = SeqGate()
    assert [g.admit(i) for i in (0, 1, 2)] == [True, True, True]
    # the boundary case: a resumed producer re-emits k, delivered once
    assert g.admit(2) is False
    assert g.admit(0) is False
    assert g.admit(3) is True
    with pytest.raises(RuntimeError):
        g.admit(5)  # a gap must fail loudly, never skip silently
    g2 = SeqGate(start=4)
    assert g2.admit(3) is False and g2.admit(4) is True


def test_replica_fault_plan_deterministic_bounded_and_validated():
    spec = "kill_mid_decode:0.5,stall:0.3:2.0:2"
    phases = ["prefill", "decode", "decode", "prefill"] * 10
    a = chaos.ReplicaFaultPlan(spec, 1234)
    b = chaos.ReplicaFaultPlan(spec, 1234)
    assert [a.consult(p) for p in phases] == [b.consult(p) for p in phases]
    assert a.consults == len(phases)
    assert a.injections <= 3  # at most 1 kill + 2 stalls per process
    # skip window: prob 1 + skip 3 fires on the 4th matching consult, once
    d = chaos.ReplicaFaultPlan("kill_mid_decode:1.0:3", 7)
    out = [d.consult("decode") for _ in range(6)]
    assert out == [None, None, None, ("kill_mid_decode", 3.0), None, None]
    # prefill consults never tick a decode rule's phase window
    e = chaos.ReplicaFaultPlan("kill_mid_decode:1.0:1", 7)
    assert [e.consult("prefill") for _ in range(5)] == [None] * 5
    assert e.consult("decode") is None and e.consult("decode") is not None
    with pytest.raises(ValueError):
        chaos.ReplicaFaultPlan("reply_drop:1.0", 1)  # rpc mode, not a replica mode
    with pytest.raises(ValueError):
        chaos.ReplicaFaultPlan("kill_mid_decode", 1)


@pytest.mark.parametrize("spec", [
    "kill_mid_decode:0.5,stall:0.3:2.0:2",
    "kill_mid_prefill:1.0:2",
    "stall:0.5:0.1:3, kill_mid_decode:0.2:1:2",
    "kill_mid_export:0.4,kill_mid_import:0.4:0:3,stall:1.0",
])
def test_replica_fault_plan_matches_jax_package(spec):
    """The same spec and seed give the JAX package's consult schedule,
    counters and derived seeds."""
    phases = random.Random(spec).choices(["prefill", "decode"], k=60)
    for seed in (1, 7, CHAOS_SEED):
        ours, ref = chaos.ReplicaFaultPlan(spec, seed), jax_chaos.ReplicaFaultPlan(spec, seed)
        assert [ours.consult(p) for p in phases] == [ref.consult(p) for p in phases]
        assert (ours.consults, ours.injections, ours.rules) == \
            (ref.consults, ref.injections, ref.rules)
        for label in ("replica", "rpc", spec):
            assert chaos.derive_plan_seed(seed, label) == jax_chaos.derive_plan_seed(seed, label)


def test_env_plan_seeds_match_jax_package(monkeypatch):
    """The process-wide plan of each engine module: an explicit seed wins,
    else one derived from the master seed, the same on both sides."""
    from ray_tpu.core.config import GLOBAL_CONFIG as JAX_CONFIG
    from ray_tpu.inference import engine as jax_engine
    from ray_tpu_torch.inference import engine as port_engine

    for mod in (jax_engine, port_engine):  # fresh caches, restored after
        monkeypatch.setattr(mod, "_RPLAN_CACHE", None)
    for conf in (GLOBAL_CONFIG, JAX_CONFIG):
        monkeypatch.setattr(conf, "testing_replica_chaos", "stall:0.5:0.1:3")
        monkeypatch.setattr(conf, "testing_replica_chaos_seed", 0)
        monkeypatch.setattr(conf, "testing_chaos_seed", 99)
    ours, ref = port_engine.active_replica_fault_plan(), jax_engine.active_replica_fault_plan()
    assert ours.seed == ref.seed == chaos.derive_plan_seed(99, "replica")
    for conf in (GLOBAL_CONFIG, JAX_CONFIG):
        monkeypatch.setattr(conf, "testing_replica_chaos_seed", 5)
    ours, ref = port_engine.active_replica_fault_plan(), jax_engine.active_replica_fault_plan()
    assert ours.seed == ref.seed == 5
    for conf in (GLOBAL_CONFIG, JAX_CONFIG):
        monkeypatch.setattr(conf, "testing_replica_chaos", "")
    assert port_engine.active_replica_fault_plan() is None


# ---------------------------------------------------------------------------
# deterministic continuation (engine level)


def test_cross_engine_determinism_and_midstream_resume(cfg, params):
    prompt = [3, 7, 11, 5]
    e1 = _engine(cfg, params)
    e2 = _engine(cfg, params)
    try:
        a = list(e1.generate(prompt, max_new_tokens=12, temperature=0.8, seed=42))
        assert len(a) == 12
        b = list(e2.generate(prompt, max_new_tokens=12, temperature=0.8, seed=42))
        assert b == a
        for k in (1, 5, 11):
            tail = list(e2.generate(prompt + a[:k], max_new_tokens=12 - k,
                                    temperature=0.8, seed=42))
            assert tail == a[k:], f"divergence resuming at k={k}"
        g = list(e1.generate(prompt, max_new_tokens=12))
        assert list(e2.generate(prompt + g[:4], max_new_tokens=8)) == g[4:]
    finally:
        e1.stop()
        e2.stop()


def test_spec_midstream_resume_byte_exact_on_any_survivor(cfg, params):
    prompt = [3, 7, 11, 5, 3, 7, 11, 5]  # repetitive: drafts actually fire
    e_spec = _engine(cfg, params, speculative_k=3)
    e_plain = _engine(cfg, params)
    try:
        ref = list(e_plain.generate(prompt, max_new_tokens=12, temperature=0.7, seed=42))
        a = list(e_spec.generate(prompt, max_new_tokens=12, temperature=0.7, seed=42))
        assert a == ref, "speculative stream diverged from plain"
        for k in (1, 5, 11):
            for survivor in (e_plain, e_spec):
                tail = list(survivor.generate(prompt + a[:k], max_new_tokens=12 - k,
                                              temperature=0.7, seed=42))
                assert tail == a[k:], (k, survivor is e_spec)
        g = list(e_plain.generate(prompt, max_new_tokens=12))
        assert list(e_spec.generate(prompt + g[:4], max_new_tokens=8)) == g[4:]
        assert e_spec.stats()["speculative"]["proposed_tokens"] > 0
    finally:
        e_spec.stop()
        e_plain.stop()


def test_resumed_request_keeps_seq_under_preemption(cfg, params):
    ref = _engine(cfg, params)
    prompt = [5, 9, 2, 4, 1, 6, 3] * 2  # 14 tokens
    try:
        full = list(ref.generate(prompt, max_new_tokens=40, temperature=0.6, seed=9))
    finally:
        ref.stop()
    # pool too small for two grown sequences: the low-priority RESUMED
    # request is evicted mid-decode by the high-priority competitor
    eng = _engine(cfg, params, num_blocks=11, prefill_buckets=(16, 32),
                  decode_buckets=(1, 2), max_decode_batch=2, max_new_tokens_default=40)
    try:
        k = 7
        lo = eng.submit(prompt + full[:k], max_new_tokens=40 - k,
                        temperature=0.6, seed=9, priority=0)
        hi = eng.submit([8, 9, 10, 11, 12, 13] * 2, max_new_tokens=40, priority=1)
        out_lo = list(eng.tokens(lo, timeout=60))
        list(eng.tokens(hi, timeout=60))
        assert eng.scheduler.total_preempted > 0, "preemption never happened"
        assert out_lo == full[k:], "resumed request diverged across preemption"
        assert eng.blocks.used_blocks == 0
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# LLMServer


def test_server_resume_mode_seq_numbers_and_midstream_resume(cfg, params):
    """Plain mode yields TokenChunk bursts of tokens; resume mode yields
    (seq, token) pairs, counts max_new_tokens against the original
    request, and a tail resumed at k on a second server equals the
    undisturbed stream from seq k."""
    a, b = _server(cfg, params), _server(cfg, params, speculative_k=3)
    try:
        for kw in ({}, {"temperature": 0.8, "seed": 42}):
            req = {"prompt": [3, 7, 11, 5], "max_new_tokens": 12, **kw}
            chunks = list(a.generate(req))
            assert chunks and all(isinstance(c, TokenChunk) for c in chunks)
            full = _flat(chunks)
            assert len(full) == 12 and a(req)["tokens"] == full
            assert _flat(a.generate({**req, "resume_from": 0})) == list(enumerate(full))
            for k in (1, 5, 11):
                for survivor in (a, b):
                    tail = _flat(survivor.generate(
                        {**req, "prompt": req["prompt"] + full[:k], "resume_from": k}))
                    assert tail == list(enumerate(full))[k:], (kw, k, survivor is b)
    finally:
        a.engine.stop()
        b.engine.stop()


def test_resume_after_delivered_eos_emits_nothing(cfg, params):
    server = _server(cfg, params)
    try:
        out = list(server.generate({
            "prompt": [3, 1, 4, 99], "max_new_tokens": 8,
            "eos_token": 99, "resume_from": 3,
        }))
        assert out == [], "resume decoded past a delivered EOS"
        out2 = _flat(server.generate({
            "prompt": [3, 1, 4, 99], "max_new_tokens": 8,
            "resume_from": 3, "request_id": "no-eos",
        }))
        assert len(out2) == 5 and out2[0][0] == 3 and out2[-1][0] == 7
        # an eos INSIDE the original prompt (nothing delivered yet) must
        # not close the stream
        out3 = list(server.generate({
            "prompt": [3, 99, 4], "max_new_tokens": 4,
            "eos_token": 99, "resume_from": 0, "request_id": "eos-in-prompt",
        }))
        assert len(out3) >= 1
        # room-clamped cap: a 60-token prompt at max_seq_len 64 clamps 10
        # new tokens to 4; all 4 delivered, the resume must close
        L = cfg.max_seq_len
        out4 = list(server.generate({
            "prompt": list(range(1, L - 3)) + [7, 7, 7, 7],
            "max_new_tokens": 10, "resume_from": 4,
            "request_id": "room-clamped",
        }))
        assert out4 == [], "resume past a room-clamped cap must close"
    finally:
        server.engine.stop()


@pytest.mark.parametrize("field", ["kv_import", "kv_tier"])
def test_kv_fields_run_as_plain_prefill(cfg, params, field):
    """No cluster can serve the fetch, so the request runs as a plain
    prefill (the reference's fallback rung) and gives the same tokens."""
    desc = {"kv_import": {"shape": [2, 2, 1, 8, 2, 16], "tokens": 8, "block_size": 8},
            "kv_tier": {"blocks": [["00" * 16, {"tier_ns": "x"}]], "tokens": 8}}[field]
    server = _server(cfg, params)
    try:
        for resume_from in (None, 0, 3):
            req = {"prompt": [9, 8, 7, 6, 5, 4, 3, 2, 1], "max_new_tokens": 6,
                   "temperature": 0.8, "seed": 3}
            if resume_from is not None:
                req["resume_from"] = resume_from
            assert _flat(server.generate({**req, field: desc})) == _flat(server.generate(req))
    finally:
        server.engine.stop()


def test_stall_reads_unhealthy_then_recovers(cfg, params):
    """A stalled step loop (``stall`` mode) reads unhealthy while it
    sleeps and healthy after; the tokens are those of an unarmed run."""
    server = _server(cfg, params, step_stall_unhealthy_s=0.3)
    req = {"prompt": [4, 8, 15, 16, 23, 42], "max_new_tokens": 8}
    try:
        want = server(req)["tokens"]
        assert server.testing_arm_replica_chaos("stall:1.0:1.5:1", 17) == 17
        out, readings = [], []
        t = threading.Thread(target=lambda: out.extend(server(req)["tokens"]))
        t.start()
        while t.is_alive():
            readings.append(server.check_health())
            time.sleep(0.02)
        t.join(timeout=60)
        assert not t.is_alive()
        assert False in readings, "the stall never read unhealthy"
        assert server.check_health()
        assert out == want
        assert server.engine.testing_fault_plan.injections == 1
    finally:
        server.engine.stop()
    assert not server.check_health()


def _kill_and_resume(cfg, params, device, env=None):
    """A child process streams a sampled request and is SIGKILLed by
    ``kill_mid_decode``; the stream resumes on this process's server
    behind a SeqGate. Returns the child's delivered count, the stream,
    the gate's next seq and the undisturbed stream."""
    req = {"prompt": [3, 7, 11, 5], "max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    delivered, rc, err = stream_in_child(req, CHAOS_SPEC, CHAOS_SEED, env=env, timeout=240,
                                         model="tiny", device=device, seed=0, engine=ENGINE)
    assert rc == -9, f"the child was not SIGKILLed (rc {rc}): {err[-2000:]}"
    assert "kill_mid_decode" in err
    server = _server(cfg, params)
    try:
        undisturbed = [t for _, t in _flat(server.generate({**req, "resume_from": 0}))]
        gate, stream = SeqGate(), []
        for seq, tok in delivered:
            if gate.admit(seq):
                stream.append(tok)
        for seq, tok in _flat(server.generate(
                {**req, "prompt": req["prompt"] + stream, "resume_from": len(stream)})):
            if gate.admit(seq):
                stream.append(tok)
    finally:
        server.engine.stop()
    return len(delivered), stream, gate.next_seq, undisturbed


def test_kill_mid_decode_in_child_resumes_through_seq_gate(cfg, params):
    """The stream resumed after the child's death has no gap and no
    repeat, and equals the undisturbed stream byte for byte."""
    k, stream, next_seq, undisturbed = _kill_and_resume(cfg, params, "cpu",
                                                        env={"OMP_NUM_THREADS": "1"})
    assert 1 <= k < 16
    assert next_seq == 16 and stream == undisturbed


def test_server_matches_jax_server():
    """The port's LLMServer against the JAX package's on the same
    JAX-initialised params: the same (seq, token) streams in plain and
    resume mode, greedy and seeded, and the same routing_stats keys."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = init_params(tcfg, 0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    from ray_tpu.inference.engine import EngineConfig as JaxEngineConfig

    ref = JaxLLMServer(jcfg, JaxEngineConfig(**ENGINE), params=jp, export_metrics=False)
    ours = _server(tcfg, model)
    try:
        for kw in ({}, {"temperature": 0.8, "seed": 5}):
            req = {"prompt": [1, 2, 3, 4, 5, 6, 7, 1, 2, 3], "max_new_tokens": 10, **kw}
            full = _flat(ours.generate(req))
            assert full == _flat(ref.generate(req))
            for k in (0, 4):
                res = {**req, "prompt": req["prompt"] + full[:k], "resume_from": k}
                got = _flat(ours.generate(res))
                assert got == _flat(ref.generate(res)) == list(enumerate(full))[k:]
        assert list(ours.routing_stats()) == list(ref.routing_stats())
    finally:
        ref.engine.stop()
        ours.engine.stop()


def test_server_surface(cfg, params):
    """Construction, the hooks carried over, and the KV-migration entry
    points on a plain engine."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: LLMServer() would build on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(cfg, EngineConfig(**ENGINE))  # params=None: cuda by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(cfg, EngineConfig(**ENGINE), params=params)  # given params: cuda too
    server = LLMServer(cfg, EngineConfig(**ENGINE), seed=0, device="cpu")
    try:
        assert server.engine.runner.device.type == "cpu"
        assert LLMServer.resumable_streams == ("generate",)
        host, port = server.metrics_address().rsplit(":", 1)
        assert host == GLOBAL_CONFIG.metrics_bind_host and int(port) > 0
        # the same seed on the same device: the same weights
        other = _server(cfg, params)
        try:
            assert server({"prompt": [1, 2, 3]})["tokens"] == other({"prompt": [1, 2, 3]})["tokens"]
        finally:
            other.engine.stop()
        server.set_deployment_name("llm")
        assert server.engine.slo_deployment == "llm"
        assert server.slo_snapshot()["books"]["finished"] >= 1
        assert server.engine_stats()["scheduler"]["total_admitted"] >= 1
        assert server.routing_stats()["kv_tier"] == {}
        rid = server.engine.submit([1, 2, 3], max_new_tokens=8)
        server.cancel(rid)
        # KV migration on a plain engine: a prompt within one block has
        # nothing to export, a longer one exports its full blocks
        assert server.prefill_export({"prompt": [1, 2, 3]}) is None
        desc = server.prefill_export({"prompt": list(range(1, 21))})
        assert desc["tokens"] == 16 and desc["dtype"] == "float32"
        assert desc["shape"][2] == 16 // ENGINE["block_size"]
        from ray_tpu_torch.inference import kv_transfer

        try:
            assert server.testing_arm_kv_tier_chaos("missing_block:1.0", 1) == 1
            assert kv_transfer.testing_tier_plan.seed == 1
        finally:
            kv_transfer.testing_tier_plan = None
        # without the tier, migrate=True is a plain drain (the reference's)
        server.begin_drain(grace_s=5.0, migrate=True)
        assert server.engine.draining and not server.engine._migrate_on_drain
        with pytest.raises(ValueError):
            server({"tokens": [1]})
        server.begin_drain(grace_s=5.0)
        assert server.engine.draining and server.check_health()
    finally:
        server.engine.stop()
        server._metrics_server.stop()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_params(cfg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    return init_params(cfg, 0)


@pytest.mark.cuda
def test_cuda_server_midstream_resume(cfg, cuda_params):
    test_server_resume_mode_seq_numbers_and_midstream_resume(cfg, cuda_params)


@pytest.mark.cuda
def test_cuda_kill_mid_decode_in_child(cfg, cuda_params):
    k, stream, next_seq, undisturbed = _kill_and_resume(cfg, cuda_params, "cuda")
    assert 1 <= k < 16
    assert next_seq == 16 and stream == undisturbed
