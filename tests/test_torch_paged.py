"""The port's paged-KV steps and ``PagedModelRunner`` against
``ray_tpu.models.llama`` / ``ray_tpu.inference.model_runner`` on the CPU,
on ``LlamaConfig.tiny()``.

Both sides start from the same params (``params_from_jax``) and the same
cache contents (``paged_cache_from_jax`` of a seeded random cache), take
the same inputs, and are compared on the logits AND the updated cache.
The engines as a whole (``ray_tpu.inference.engine`` and the port's) are
compared on their token streams and books.

Tolerances and why:
* f32: relative RMS error <= 1e-5 and max abs <= 1e-4 (another summation
  order in every matmul and softmax; ~3e-7 relative measured);
* bf16: relative RMS error <= 2^-5 on the logits and 2^-7 on the cache
  (both frameworks round every op's output to bf16, but not always at the
  same point: XLA fuses elementwise chains in f32; ~9e-3 and ~1.2e-3
  measured);
* the block copy/gather/scatter programs move bytes only: byte-exact.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference.model_runner import PagedModelRunner as JaxRunner
from ray_tpu.models import llama as jl
from ray_tpu_torch.inference.kv_cache import PagedBlockManager
from ray_tpu_torch.inference.model_runner import PagedModelRunner
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)

NUM_BLOCKS, BS = 16, 8
M = 64 // BS  # tiny max_seq_len / block size
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
#: (logits, cache) relative RMS bounds per dtype; f32 adds max abs 1e-4
REL_RMS = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -5, 2.0 ** -7)}
_jit = {}


def jit_step(name, cfg):
    key = (name, cfg)
    if key not in _jit:
        _jit[key] = jax.jit(partial(getattr(jl, name), cfg))
    return _jit[key]


@pytest.fixture(scope="module", params=list(DTYPES))
def pair(request):
    """(dtype name, jax cfg, jax params, port cfg, port model)."""
    jdt, tdt = DTYPES[request.param]
    jcfg, tcfg = jl.LlamaConfig.tiny(dtype=jdt), tl.LlamaConfig.tiny(dtype=tdt)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = tl.init_params(tcfg, 0, device="cpu")
    model.load_state_dict(tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return request.param, jcfg, jp, tcfg, model


def random_caches(jcfg, seed):
    """The same random cache contents on both sides (JAX dict, port dict)."""
    rs = np.random.RandomState(seed)
    shape = (jcfg.n_layers, NUM_BLOCKS, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jc = {n: jnp.asarray(rs.randn(*shape).astype(np.float32), jcfg.dtype) for n in ("k", "v")}
    return jc, tl.paged_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc))


def rel_rms(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(((ours - ref) ** 2).mean() / (ref ** 2).mean()))


def assert_close(name, ours, ref, bound):
    err = rel_rms(ours, ref)
    assert err <= bound, f"{name}: relative RMS {err:.3g} > {bound:.3g}"
    if name.endswith("f32"):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4, err_msg=name)


def check_step(tag, pair, jc2, jlogits, tc, tlogits):
    dt = pair[0]
    lbound, cbound = REL_RMS[dt]
    assert_close(f"{tag} logits {dt}", tlogits.numpy(), np.asarray(jlogits), lbound)
    for n in ("k", "v"):
        assert_close(f"{tag} cache {n} {dt}", tc[n].float().numpy(),
                     np.asarray(jc2[n], np.float32), cbound)


def ids(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def test_paged_prefill_step_matches_jax(pair):
    dt, jcfg, jp, tcfg, model = pair
    jc, tc = random_caches(jcfg, seed=1)
    toks = np.random.RandomState(2).randint(1, jcfg.vocab_size, 8).astype(np.int32)
    table = np.array([3, 7, 1, 0, 0, 0, 0, 0], np.int32)  # ctx 5 cached + chunk of 6
    jc2, jlog = jit_step("paged_prefill_step", jcfg)(jp, jc, toks, table, np.int32(5),
                                                     np.int32(6))
    tlog = tl.paged_prefill_step(tcfg, model, tc, ids(toks), ids(table), 5, 6)
    assert tlog.shape == (jcfg.vocab_size,) and tlog.dtype == torch.float32
    check_step("prefill", pair, jc2, jlog, tc, tlog)


def test_paged_decode_step_matches_jax(pair):
    dt, jcfg, jp, tcfg, model = pair
    jc, tc = random_caches(jcfg, seed=3)
    # three live slots (one crossing into its second block) + one padding
    # slot (ctx_len 1 on the null block)
    toks = np.array([11, 200, 5, 0], np.int32)
    pos = np.array([4, 8, 13, 0], np.int32)
    tables = np.zeros((4, M), np.int32)
    tables[0, :1] = [2]
    tables[1, :2] = [4, 9]
    tables[2, :2] = [6, 12]
    ctx = np.array([5, 9, 14, 1], np.int32)
    jc2, jlog = jit_step("paged_decode_step", jcfg)(jp, jc, toks, pos, tables, ctx)
    tlog = tl.paged_decode_step(tcfg, model, tc, ids(toks), ids(pos), ids(tables), ids(ctx))
    assert tlog.shape == (4, jcfg.vocab_size)
    check_step("decode", pair, jc2, jlog, tc, tlog)


def test_paged_verify_step_matches_jax(pair):
    dt, jcfg, jp, tcfg, model = pair
    jc, tc = random_caches(jcfg, seed=4)
    # two windows of 5 (one straddling a block boundary), one of 3, one
    # padding slot with true_len 0
    toks = np.random.RandomState(5).randint(1, jcfg.vocab_size, (4, 5)).astype(np.int32)
    tables = np.zeros((4, M), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :1] = [3]
    tables[2, :3] = [5, 8, 10]
    ctx = np.array([6, 2, 17, 0], np.int32)
    tlen = np.array([5, 3, 5, 0], np.int32)
    jc2, jlog = jit_step("paged_verify_step", jcfg)(jp, jc, toks, tables, ctx, tlen)
    tlog = tl.paged_verify_step(tcfg, model, tc, ids(toks), ids(tables), ids(ctx), ids(tlen))
    assert tlog.shape == (4, 5, jcfg.vocab_size)
    check_step("verify", pair, jc2, jlog, tc, tlog)


def test_block_copy_gather_scatter_byte_exact(pair):
    dt, jcfg, jp, tcfg, model = pair
    jc, tc = random_caches(jcfg, seed=6)
    src, dst = np.array([3, 5, 0, 0], np.int32), np.array([9, 2, 0, 0], np.int32)
    jc = jax.jit(jl.copy_paged_blocks)(jc, src, dst)
    tl.copy_paged_blocks(tc, ids(src), ids(dst))
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n].float().numpy(), np.asarray(jc[n], np.float32))
    blocks = np.array([9, 4, 1, 0], np.int32)
    jkv = jax.jit(jl.gather_paged_blocks)(jc, blocks)
    tkv = tl.gather_paged_blocks(tc, ids(blocks))
    np.testing.assert_array_equal(tkv.float().numpy(), np.asarray(jkv, np.float32))
    # write the gathered blocks back at other ids (padding on the null block)
    to = np.array([11, 12, 13, 0], np.int32)
    jc = jax.jit(jl.scatter_paged_blocks)(jc, to, jkv)
    tl.scatter_paged_blocks(tc, ids(to), tkv)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n].float().numpy(), np.asarray(jc[n], np.float32))


def test_paged_cache_from_jax_carries_bf16_bits():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.bfloat16)
    jc, tc = random_caches(jcfg, seed=7)
    assert tc["k"].dtype == torch.bfloat16 and tuple(tc["k"].shape) == jc["k"].shape
    np.testing.assert_array_equal(tc["v"].float().numpy(), np.asarray(jc["v"], np.float32))


def test_runner_matches_jax_runner_per_step():
    """The slice as a whole at the runner: chunked prefill, COW copy and
    batched decode of two requests through both runners, on the same
    params and the same token stream (the JAX side's greedy picks, fed to
    both), logits compared per call (f32 bound above)."""
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = tl.init_params(tcfg, 0, device="cpu")
    model.load_state_dict(tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    kw = dict(num_blocks=NUM_BLOCKS, block_size=BS, prefill_buckets=(4, 8),
              decode_buckets=(1, 2))
    jr, tr = JaxRunner(jcfg, jp, **kw), PagedModelRunner(tcfg, model, **kw)
    mgr = PagedBlockManager(NUM_BLOCKS, BS)
    rs = np.random.RandomState(8)
    state = {}
    for rid, n in (("a", 11), ("b", 6)):
        prompt = [int(x) for x in rs.randint(1, jcfg.vocab_size, size=n)]
        mgr.grow_to(rid, n + 4)
        row = mgr.table_row(rid, tr.max_blocks_per_seq)
        for pos in range(0, n, 4):
            chunk = prompt[pos : pos + 4]
            jlog = jr.prefill_chunk(chunk, row, pos)
            assert_close("runner prefill f32", tr.prefill_chunk(chunk, row, pos), jlog, 1e-5)
        state[rid] = (prompt, [int(jlog.argmax())])
    # duplicate a's first block into a fresh block on both sides
    src = mgr.owned("a")[0]
    jr.copy_blocks([(src, 15)])
    tr.copy_blocks([(src, 15)])
    np.testing.assert_array_equal(tr.cache["k"][:, 15].numpy(), tr.cache["k"][:, src].numpy())
    for n in ("k", "v"):
        assert_close(f"runner cache {n} f32", tr.cache[n].numpy(), np.asarray(jr.cache[n]), 1e-5)
    for _ in range(3):
        toks, poss, rows, cls = [], [], [], []
        for rid, (prompt, gen) in state.items():
            p = len(prompt) + len(gen) - 1
            toks.append(gen[-1])
            poss.append(p)
            rows.append(mgr.table_row(rid, tr.max_blocks_per_seq))
            cls.append(p + 1)
        jlog = jr.decode(toks, poss, rows, cls)
        assert_close("runner decode f32", tr.decode(toks, poss, rows, cls), jlog, 1e-5)
        for (rid, (_, gen)), lg in zip(state.items(), jlog):
            gen.append(int(lg.argmax()))
    # prefill bucket 4, the COW copy, decode bucket 2
    assert tr.compile_count() == jr.compile_count() == 1 + 1 + 1


def _engine_streams(engine_mod, cfg, params):
    """Two waves through one engine, each wave submitted whole before the
    step loop runs (so both engines schedule the same batches): wave 1
    holds a repetitive prompt (n-gram drafts accepted and rolled back), a
    prompt of 3 prefill chunks and a seeded temperature-0.8 request; wave
    2 repeats a cached prompt exactly (a full-prompt hit: COW) and extends
    another (a partial hit). Returns the token streams and the books.
    Adaptive k is off: it steers on a wall-clock window, so the books
    would depend on timing (the streams would not)."""
    ec = engine_mod.EngineConfig(
        num_blocks=64, block_size=8, prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
        max_decode_batch=4, speculative_k=4, speculative_adaptive=False,
        prefix_cache_enabled=True, warmup=False)
    rs = np.random.RandomState(21)
    rep = [1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5]
    long_ = [int(x) for x in rs.randint(1, cfg.vocab_size, size=40)]
    sampled = [int(x) for x in rs.randint(1, cfg.vocab_size, size=9)]
    waves = [
        [(rep, {}), (long_, {}), (sampled, dict(temperature=0.8, seed=5))],
        [(long_[:16], {}), (rep + [9, 9], {}), (sampled, dict(temperature=0.8, seed=5))],
    ]
    eng = engine_mod.InferenceEngine(cfg, params, ec)
    streams = []
    try:
        for wave in waves:
            rids = [eng.submit(p, max_new_tokens=10, request_id=f"r{len(streams)}-{i}", **kw)
                    for i, (p, kw) in enumerate(wave)]
            eng.start()
            streams += [list(eng.tokens(r, timeout=120)) for r in rids]
            eng.stop()
        stats = eng.stats()
    finally:
        eng.stop()
    books = {k: stats["prefix_cache"][k] for k in ("hits_total", "cow_copies_total")}
    books.update({k: stats["speculative"][k]
                  for k in ("proposed_tokens", "accepted_tokens", "rollbacks")})
    return streams, books


def test_engine_matches_jax_engine():
    """The host logic of the engine as a whole against the JAX package's
    engine, on the same f32 params: concurrent prompts with chunked
    prefill, the prefix cache and COW, a seeded temperature-0.8 request
    and n-gram speculative decoding (k=4). The token streams must be
    identical, and so must the prefix-cache and speculative books."""
    from ray_tpu.inference import engine as jax_engine
    from ray_tpu_torch.inference import engine as port_engine

    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    model = tl.init_params(tcfg, 0, device="cpu")
    model.load_state_dict(tl.params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    jstreams, jbooks = _engine_streams(jax_engine, jcfg, jp)
    tstreams, tbooks = _engine_streams(port_engine, tcfg, model)
    assert [len(s) for s in jstreams] == [10] * 6
    assert tstreams == jstreams
    assert tbooks == jbooks
    # the run went through what it claims to compare
    assert jbooks["hits_total"] >= 2 and jbooks["cow_copies_total"] >= 1
    assert jbooks["accepted_tokens"] > 0 and jbooks["rollbacks"] > 0
    assert jstreams[2] == jstreams[5]  # the seeded request repeats its stream


# ---------------------------------------------------------------------------
# within the port


@pytest.fixture(scope="module")
def tiny():
    cfg = tl.LlamaConfig.tiny()
    return cfg, tl.init_params(cfg, 0, device="cpu")


def dense_greedy(cfg, params, prompt, n):
    """Greedy continuation through the dense ``forward``, padded to
    max_seq_len (causal masking makes the padding inert)."""
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            padded = torch.zeros((1, cfg.max_seq_len), dtype=torch.long)
            padded[0, : len(toks)] = torch.tensor(toks)
            nxt = int(tl.forward(cfg, params, padded)[0, len(toks) - 1].argmax())
            out.append(nxt)
            toks.append(nxt)
    return out


def test_paged_prefill_decode_matches_dense(tiny):
    """Port of ``tests/test_inference.py::test_paged_prefill_decode_matches_dense``."""
    cfg, params = tiny
    runner = PagedModelRunner(
        cfg, params, num_blocks=32, block_size=8,
        prefill_buckets=(4, 8), decode_buckets=(1, 4),
    )
    mgr = PagedBlockManager(32, 8)
    rs = np.random.RandomState(7)
    state = {}
    for rid, n in (("r0", 11), ("r1", 5), ("r2", 9)):
        prompt = [int(x) for x in rs.randint(1, cfg.vocab_size, size=n)]
        mgr.grow_to(rid, n + 1)
        row = mgr.table_row(rid, runner.max_blocks_per_seq)
        pos = 0
        while pos < n:  # chunked prefill, chunks of <= 4
            chunk = prompt[pos : pos + 4]
            logits = runner.prefill_chunk(chunk, row, pos)
            pos += len(chunk)
        state[rid] = {"prompt": prompt, "gen": [int(logits.argmax())]}
    for _ in range(5):  # batched decode across all three requests
        rids = list(state)
        toks, poss, rows, cls = [], [], [], []
        for rid in rids:
            st = state[rid]
            p = len(st["prompt"]) + len(st["gen"]) - 1
            mgr.grow_to(rid, p + 2)
            toks.append(st["gen"][-1])
            poss.append(p)
            rows.append(mgr.table_row(rid, runner.max_blocks_per_seq))
            cls.append(p + 1)
        logits = runner.decode(toks, poss, rows, cls)
        for rid, lg in zip(rids, logits):
            state[rid]["gen"].append(int(lg.argmax()))
    for st in state.values():
        assert st["gen"] == dense_greedy(cfg, params, st["prompt"], 6)


def test_runner_compile_accounting(tiny):
    cfg, params = tiny
    runner = PagedModelRunner(cfg, params, num_blocks=16, block_size=8,
                              prefill_buckets=(8, 16), decode_buckets=(1, 2, 4),
                              verify_buckets=(3,))
    assert runner.compile_count() == 0 and runner.recompiles_after_warmup() == 0
    runner.warmup(kv_io=True)
    # prefill + decode + (verify x decode) + COW + gather + scatter
    assert runner.compile_count() == 2 + 3 + 3 + 1 + 1 + 1
    row = [1] + [0] * (runner.max_blocks_per_seq - 1)
    runner.prefill_chunk([3, 4, 5], row, 0)
    runner.decode([5, 6], [3, 0], [row, row], [4, 1])
    runner.verify_batch([[1, 2, 3]], [row], [3])
    runner.copy_blocks([(1, 2)] * 5)  # two COW calls of the same width
    assert runner.recompiles_after_warmup() == 0
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        runner.prefill_chunk(list(range(17)), row, 0)
    assert runner.compile_count() == 11


def test_runner_counts_a_shape_first_seen_after_warmup(tiny):
    cfg, params = tiny
    runner = PagedModelRunner(cfg, params, num_blocks=16, block_size=8,
                              prefill_buckets=(8, 16), decode_buckets=(1, 2))
    runner.warmup(buckets_prefill=(8,), buckets_decode=(1,))
    assert runner.compile_count() == 1 + 1 + 1
    row = [1, 2] + [0] * (runner.max_blocks_per_seq - 2)
    runner.prefill_chunk(list(range(1, 11)), row, 0)  # bucket 16: new
    runner.prefill_chunk([3], row, 10)  # bucket 8: warm
    assert runner.recompiles_after_warmup() == 1
    runner.decode([4, 5], [11, 0], [row, row], [12, 1])  # batch bucket 2: new
    assert runner.recompiles_after_warmup() == 2 and runner.compile_count() == 5


def test_runner_gather_scatter_blocks_roundtrip(tiny):
    cfg, params = tiny
    runner = PagedModelRunner(cfg, params, num_blocks=16, block_size=8,
                              prefill_buckets=(8,), decode_buckets=(1,))
    rs = np.random.RandomState(9)
    with torch.inference_mode():
        for n in ("k", "v"):
            runner.cache[n].copy_(torch.from_numpy(rs.randn(*runner.cache[n].shape)))
    ids_ = [3, 9, 1, 4, 7, 2, 8, 5, 6, 10]  # more than one _KV_IO_WIDTH chunk
    kv = runner.gather_blocks(ids_)
    assert kv.shape == (2, cfg.n_layers, 10, 8, cfg.n_kv_heads, cfg.head_dim)
    assert isinstance(kv, np.ndarray) and kv.dtype == np.float32
    np.testing.assert_array_equal(kv[0, :, 1], runner.cache["k"][:, 9].numpy())
    runner.scatter_blocks([11, 12, 13], kv[:, :, :3])
    np.testing.assert_array_equal(runner.cache["v"][:, 12].numpy(), kv[1, :, 1])
    assert runner.gather_blocks([]).shape[2] == 0


def test_live_scatter_targets_never_coincide(tiny, monkeypatch):
    """Padding positions all write into the null block, where a duplicate
    index_put_ target is harmless; a duplicate on a live block would make
    the write order matter, and a live block owned by another request (or
    shared, or by none) would be corrupted. Every scatter of an engine run
    with chunked prefill, batched decode, COW and speculative windows is
    checked."""
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine

    cfg, params = tiny
    seen = {"calls": 0}
    real = tl._scatter_kv

    def checked(cache, layer, blk, off, k, v):
        live = blk != 0
        slots = (blk[live] * cache["k"].shape[2] + off[live]).tolist()
        assert len(slots) == len(set(slots)), f"duplicate live scatter targets: {slots}"
        owners = {}
        for req in list(eng.scheduler.running):
            for b in eng.blocks.owned(req.request_id):
                owners.setdefault(b, set()).add(req.request_id)
        for b in set(blk[live].tolist()):
            assert len(owners.get(b, ())) == 1 and eng.blocks.refcount(b) == 1, \
                f"block {b} written: owners {owners.get(b)}, refcount {eng.blocks.refcount(b)}"
        seen["calls"] += 1
        return real(cache, layer, blk, off, k, v)

    monkeypatch.setattr(tl, "_scatter_kv", checked)
    ec = EngineConfig(num_blocks=32, block_size=8, prefill_buckets=(8, 16),
                      decode_buckets=(1, 2, 4), max_decode_batch=4, warmup=False,
                      speculative_k=3)
    eng = InferenceEngine(cfg, params, ec)
    eng.start()
    try:
        prompts = [[1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5], [9, 8, 7, 6] * 4, [4, 4, 4, 4, 4]]
        rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        outs = [list(eng.tokens(r, timeout=60)) for r in rids]
        again = list(eng.generate(prompts[1], max_new_tokens=4))  # prefix hit + COW
    finally:
        eng.stop()
    assert [len(o) for o in outs] == [12, 12, 12] and len(again) == 4
    assert eng.stats()["speculative"]["proposed_tokens"] > 0
    assert eng.blocks.cow_copies_total >= 1
    assert seen["calls"] > 0


def test_paged_steps_refuse_moe():
    cfg = tl.LlamaConfig.tiny(moe_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.paged_decode_step(cfg, None, {"k": torch.zeros(1, 1, 8, 1, 1)}, None, None,
                             torch.zeros((1, 1), dtype=torch.long), None)
