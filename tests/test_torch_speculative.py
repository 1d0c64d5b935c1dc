"""Speculative decoding in the port's engine: ports of
``tests/test_speculative.py``, run on the CPU on ``LlamaConfig.tiny()``,
with its byte-exact cases held within the port (speculative output ==
plain output, for greedy and seeded temperature > 0).

``test_rollback_never_pollutes_prefix_index`` holds the prefix index alone
on a plain engine, and ``test_rollback_never_pollutes_prefix_index_or_tier``
(the reference's case) the index and the cluster KV tier's adverts on a
tier engine.
"""

import pytest
import torch

from ray_tpu_torch.inference import EngineConfig, InferenceEngine, PagedBlockManager
from ray_tpu_torch.inference.kv_cache import _chain_digest
from ray_tpu_torch.inference.speculative import NgramProposer
from ray_tpu_torch.models.llama import LlamaConfig, init_params

torch.set_num_threads(1)

#: repetitive prompt: the ngram proposer finds matches, so speculative
#: steps exercise BOTH accept and rollback against the random target
PROMPT = [1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5]


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 0, device="cpu")


@pytest.fixture(scope="module")
def draft_params(cfg):
    # another seed -> the draft disagrees with the target often enough to
    # exercise rollback, agrees rarely enough to exercise accept
    return init_params(cfg, 7, device="cpu")


def _ec(**overrides):
    kw = dict(
        num_blocks=64, block_size=8, prefill_buckets=(8, 16),
        decode_buckets=(1, 2, 4), max_decode_batch=4,
        max_new_tokens_default=8, warmup=False,
    )
    kw.update(overrides)
    return EngineConfig(**kw)


def _run(cfg, params, ec, *, temp=0.0, seed=None, n=20, **gen_kw):
    eng = InferenceEngine(cfg, params, ec).start()
    try:
        out = list(eng.generate(PROMPT, max_new_tokens=n, temperature=temp, seed=seed,
                                **gen_kw))
        return out, eng.stats()
    finally:
        eng.stop()


def _digests(tokens, bs=8):
    """Full-block chain digests of ``tokens`` (the prefix index's key space)."""
    out, prev = [], b""
    for end in range(bs, len(tokens) + 1, bs):
        prev = _chain_digest(prev, tokens[end - bs : end])
        out.append(prev)
    return out


# ---------------------------------------------------------------------------
# units: proposer + rollback bookkeeping


def test_ngram_proposer_prompt_lookup():
    p = NgramProposer(max_ngram=3, min_ngram=1)
    assert p.propose([1, 2, 3, 9, 8, 1, 2, 3], 3) == [9, 8, 1]
    assert p.propose([1, 2, 3, 9, 8, 1, 2, 3], 99) == [9, 8, 1, 2, 3]
    assert p.propose([5, 6, 7, 4, 7, 5, 6, 7], 1) == [4]
    assert p.propose([2, 8, 2, 9, 2], 1, request_id="r") == [9]
    assert p.propose([1, 2, 3, 4, 5], 4) == []
    assert p.propose([1, 2, 3], 0) == []
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=1, min_ngram=2)


def test_trim_to_rewinds_block_books_exactly():
    bm = PagedBlockManager(16, 8)
    base = bm.stats()["free_blocks"]
    assert bm.grow_to("r", 12)
    assert bm.grow_to("r", 12 + 7)
    allocs = bm.total_allocs
    assert bm.stats()["free_blocks"] == base - 3
    assert bm.trim_to("r", 12) == 1
    assert bm.stats()["free_blocks"] == base - 2
    assert bm.trim_to("r", 12) == 0
    assert bm.trim_to("missing", 4) == 0
    bm.free("r")
    assert bm.stats()["free_blocks"] == base
    assert bm.total_allocs == allocs and bm.total_frees == allocs


# ---------------------------------------------------------------------------
# byte-exactness: speculative output == plain output, always


@pytest.mark.parametrize("temp,seed", [(0.0, None), (0.8, 123)])
def test_cross_engine_byte_exact_ngram(cfg, params, temp, seed):
    ref, _ = _run(cfg, params, _ec(), temp=temp, seed=seed)
    # k=7 -> an 8-wide verify window on block_size 8: windows straddle
    # block boundaries, so rollback exercises tail-block rewind
    for k in (2, 7):
        out, st = _run(cfg, params, _ec(speculative_k=k), temp=temp, seed=seed)
        assert out == ref, (k, temp)
        assert st["speculative"]["proposed_tokens"] > 0


def test_cross_engine_byte_exact_draft_model(cfg, params, draft_params):
    for temp, seed in ((0.0, None), (0.8, 123)):
        ref, _ = _run(cfg, params, _ec(), temp=temp, seed=seed)
        out, st = _run(
            cfg, params,
            _ec(speculative_k=3, speculative_draft="model", draft_config=cfg,
                draft_params=draft_params, draft_num_blocks=32),
            temp=temp, seed=seed,
        )
        assert out == ref, temp
        sp = st["speculative"]
        assert sp["draft"] == "model" and sp["proposed_tokens"] > 0


def test_draft_model_initialised_from_seed_on_params_device(cfg, params):
    ec = _ec(speculative_k=2, speculative_draft="model", draft_config=cfg, draft_seed=7,
             draft_num_blocks=32)
    eng = InferenceEngine(cfg, params, ec)
    draft = eng.spec.runner.params
    assert draft.embed.device == params.embed.device
    torch.testing.assert_close(draft.embed, init_params(cfg, 7, device="cpu").embed,
                               rtol=0, atol=0)


def test_draft_equals_target_accepts_everything(cfg, params):
    out, st = _run(
        cfg, params,
        _ec(speculative_k=4, speculative_draft="model", draft_config=cfg,
            draft_params=params, speculative_adaptive=False),
    )
    ref, _ = _run(cfg, params, _ec())
    sp = st["speculative"]
    assert out == ref
    assert sp["rollbacks"] == 0
    assert sp["accepted_tokens"] == sp["proposed_tokens"] > 0


def test_per_request_off_switch(cfg, params):
    ref, _ = _run(cfg, params, _ec())
    out, st = _run(cfg, params, _ec(speculative_k=4), speculative=False)
    assert out == ref
    assert st["speculative"]["proposed_tokens"] == 0


# ---------------------------------------------------------------------------
# isolation: rejected positions never escape the verified cursor


class _Garbage:
    """An always-wrong proposer: every verify step writes a rejected tail
    into the paged cache, every step rolls back."""

    def propose(self, ctx, k, request_id=""):
        return [255] * k

    def release(self, request_id):
        pass

    def compile_count(self):
        return 0

    def recompiles_after_warmup(self):
        return 0


def test_rollback_never_pollutes_prefix_index(cfg, params):
    eng = InferenceEngine(cfg, params, _ec(speculative_k=4, speculative_adaptive=False)).start()
    try:
        eng.spec = _Garbage()
        out = list(eng.generate(PROMPT, max_new_tokens=20, temperature=0.0))
        st = eng.stats()
        assert st["speculative"]["rollbacks"] > 0
        assert st["speculative"]["proposed_tokens"] > 0
        # every indexed prefix digest keys verified tokens only
        verified = set(d.hex() for d in _digests(PROMPT + out))
        with eng.blocks._lock:
            indexed = set(d.hex() for d in eng.blocks._index)
        assert indexed <= verified
        bs = eng.blocks.stats()
        assert bs["holders"] == 0
        assert bs["used_blocks"] == 0
        n_full_verified = (len(PROMPT) + len(out) - 1) // bs["block_size"]
        assert bs["prefix_cached_blocks"] == n_full_verified
    finally:
        eng.stop()
    ref, _ = _run(cfg, params, _ec())
    assert out == ref


def test_rollback_never_pollutes_prefix_index_or_tier(cfg, params):
    """With the KV tier on, every tier advert (prefill and decode-boundary
    write-backs) and every indexed digest keys verified tokens only: the
    rejected drafts' positions never reach either."""
    from ray_tpu_torch.inference import kv_transfer

    eng = InferenceEngine(cfg, params, _ec(
        speculative_k=4, kv_transfer_enabled=True, kv_tier_enabled=True,
        speculative_adaptive=False)).start()
    try:
        eng.spec = _Garbage()
        out = list(eng.generate(PROMPT, max_new_tokens=20, temperature=0.0))
        st = eng.stats()
        assert st["speculative"]["rollbacks"] > 0
        assert eng.flush_tier_writebacks()
        verified = set(d.hex() for d in _digests(PROMPT + out))
        adverts = set(eng._tier_adverts)
        # the written prefix's full blocks are all adverted, nothing else
        n_full_verified = (len(PROMPT) + len(out) - 1) // 8
        assert adverts <= verified and len(adverts) == n_full_verified
        assert st["speculative"]["proposed_tokens"] > 0
        with eng.blocks._lock:
            indexed = set(d.hex() for d in eng.blocks._index)
        assert indexed <= verified
        bs = eng.blocks.stats()
        assert bs["holders"] == 0 and bs["used_blocks"] == 0
        assert bs["prefix_cached_blocks"] == n_full_verified
    finally:
        eng.stop()
        with kv_transfer._LOCAL_TIER_LOCK:
            kv_transfer._LOCAL_TIER.clear()
    ref, _ = _run(cfg, params, _ec())
    assert out == ref


# ---------------------------------------------------------------------------
# adaptive k + compile gate


def test_adaptive_k_shrinks_and_recovers(cfg, params):
    eng = InferenceEngine(cfg, params, _ec(speculative_k=4)).start()
    try:
        assert eng.scheduler.spec_k_live == 4
        eng._spec_proposed, eng._spec_accepted = 16, 1
        eng._next_gauge_refresh = 0.0
        eng._update_gauges(0)
        assert eng.scheduler.spec_k_live == 3
        assert eng.stats()["speculative"]["k_live"] == 3
        eng._spec_proposed, eng._spec_accepted = 32, 17
        eng._next_gauge_refresh = 0.0
        eng._update_gauges(0)
        assert eng.scheduler.spec_k_live == 4
        eng._spec_proposed, eng._spec_accepted = 33, 17
        eng._next_gauge_refresh = 0.0
        eng._update_gauges(0)
        assert eng.scheduler.spec_k_live == 4
    finally:
        eng.stop()


def test_zero_recompiles_after_warmup_with_draft(cfg, params):
    ec = _ec(
        prefill_buckets=(16,), decode_buckets=(1,), max_decode_batch=1, warmup=True,
        speculative_k=2, speculative_draft="model", draft_config=cfg, draft_params=params,
        draft_num_blocks=32, draft_prefill_buckets=(16,), speculative_adaptive=False,
    )
    eng = InferenceEngine(cfg, params, ec).start()
    try:
        warm = eng.stats()["compile_count"]
        out = list(eng.generate(PROMPT, max_new_tokens=10, temperature=0.0))
        st = eng.stats()
        assert len(out) == 10
        assert st["speculative"]["accepted_tokens"] > 0
        assert st["compile_count"] == warm
        assert st["recompiles_after_warmup"] == 0
    finally:
        eng.stop()


def test_plain_engine_keeps_exact_compile_count(cfg, params):
    ec = _ec(prefill_buckets=(8, 16), decode_buckets=(1, 2), max_decode_batch=2, warmup=True)
    eng = InferenceEngine(cfg, params, _ec()).start()
    eng.stop()
    eng = InferenceEngine(cfg, params, ec).start()
    try:
        assert eng.runner.compile_count() == 2 + 2 + 1
        assert eng.stats()["compile_count"] == 2 + 2 + 1
    finally:
        eng.stop()


@pytest.mark.cuda
def test_cuda_speculative_equals_plain(cfg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, PyTorch/CUDA port)")
    params = init_params(cfg, 0)
    for temp, seed in ((0.0, None), (0.8, 123)):
        ref, _ = _run(cfg, params, _ec(), temp=temp, seed=seed)
        out, st = _run(cfg, params, _ec(speculative_k=4), temp=temp, seed=seed)
        assert out == ref and st["speculative"]["proposed_tokens"] > 0
