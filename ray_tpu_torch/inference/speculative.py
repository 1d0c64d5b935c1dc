"""Speculative decoding: draft proposers for the paged-KV engine (port of
``ray_tpu.inference.speculative``).

The engine's decode loop amortizes per-token step overhead by letting a
cheap *proposer* guess k tokens ahead, then verifying all k+1 positions
in ONE bucketed target step (``models.llama.paged_verify_step`` —
chunked-prefill-shaped, all-position logits). Because the engine's
(request_seed, absolute-position) RNG pins the whole output stream given
(seed, prompt), acceptance is **exact-match**: the target's
deterministically-realized token at each position is computed from the
verify logits with the engine's own sampler, drafts are accepted while
they match it, and the first mismatch position emits the target's token
instead (the "bonus/correction" token) — so every speculative step emits
at least one token and the emitted stream is byte-identical to plain
decode by construction, for greedy AND seeded temperature>0 sampling.
The proposer therefore only affects THROUGHPUT (acceptance rate), never
content: any drafting strategy is sound.

Two proposers:

* :class:`NgramProposer` — model-free prompt-lookup decoding: find the
  most recent previous occurrence of the context's trailing n-gram and
  propose the tokens that followed it. Zero device cost, no extra
  compile footprint; wins exactly on repetitive continuations (code,
  structured text, resumed prefixes).
* :class:`DraftModelProposer` — a scaled-down same-tokenizer draft
  model running greedy decode on its OWN paged runner + block pool.
  Catch-up is incremental: the proposer tracks which token history its
  draft cache actually holds and re-feeds only the diverged tail
  (rejected drafts overwrite in place — the paged layout addresses K/V
  purely by position, so stale slots past the committed context are
  inert until rewritten).

Both expose the same surface the engine drives: ``propose(ctx, k)``,
``release(request_id)``, ``compile_count()`` /
``recompiles_after_warmup()`` for the zero-recompile gate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ray_tpu_torch.inference.kv_cache import PagedBlockManager
from ray_tpu_torch.inference.model_runner import PagedModelRunner


class NgramProposer:
    """Prompt-lookup drafting: propose the continuation of the most
    recent previous occurrence of the context's trailing n-gram.

    Tries the longest configured n-gram first (stronger evidence) and
    falls back to shorter ones; returns ``[]`` when nothing in the
    context repeats — the engine then runs that slot as plain decode.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need max_ngram >= min_ngram >= 1")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(
        self, ctx: Sequence[int], k: int, request_id: str = ""
    ) -> List[int]:
        L = len(ctx)
        if k <= 0 or L < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pattern = tuple(ctx[L - n :])
            # scan right-to-left for the most recent PRIOR occurrence
            # (the trailing occurrence itself is excluded)
            for i in range(L - n - 1, -1, -1):
                if tuple(ctx[i : i + n]) == pattern:
                    return list(ctx[i + n : i + n + k])
        return []

    def release(self, request_id: str) -> None:  # stateless
        pass

    def compile_count(self) -> int:
        return 0

    def recompiles_after_warmup(self) -> int:
        return 0


class DraftModelProposer:
    """Greedy k-step drafting with a scaled-down model on its own paged
    runner. Per-request draft-cache state is tracked host-side as the
    exact token history whose K/V the draft cache holds; every propose
    call re-feeds only the diverged tail (after a rollback that is the
    rejected drafts' positions, overwritten in place)."""

    def __init__(
        self,
        cfg,
        params,
        *,
        num_blocks: int,
        block_size: int,
        prefill_buckets: Sequence[int],
        decode_buckets: Sequence[int] = (1,),
        cache_dtype=None,
    ):
        self.cfg = cfg
        self.runner = PagedModelRunner(
            cfg,
            params,
            num_blocks=num_blocks,
            block_size=block_size,
            prefill_buckets=prefill_buckets,
            decode_buckets=decode_buckets,
            cache_dtype=cache_dtype,
        )
        self.blocks = PagedBlockManager(num_blocks, block_size)
        #: request -> tokens whose K/V the draft cache holds at
        #: positions 0..len-1 (includes stale speculative tails until
        #: the next propose overwrites them)
        self._written: Dict[str, List[int]] = {}

    # -- warmup / compile accounting (ride the engine's gates) ----------
    def warmup(self) -> None:
        self.runner.warmup()

    def mark_warm(self) -> None:
        self.runner.mark_warm()

    def compile_count(self) -> int:
        return self.runner.compile_count()

    def recompiles_after_warmup(self) -> int:
        return self.runner.recompiles_after_warmup()

    # -- drafting -------------------------------------------------------
    def propose(self, ctx: Sequence[int], k: int, request_id: str = "") -> List[int]:
        L = len(ctx)
        if k <= 0 or L < 1:
            return []
        k = min(k, self.cfg.max_seq_len - L)
        if k <= 0:
            return []
        rid = request_id or "draft"
        held = self._written.get(rid, [])
        # longest prefix of the draft cache that is still the truth
        p = 0
        limit = min(len(held), L - 1)
        while p < limit and held[p] == ctx[p]:
            p += 1
        # decode writes K/V at positions L-1 .. L+k-2: need L-1+k covered
        if not self.blocks.grow_to(rid, L - 1 + k):
            return []  # draft pool dry: skip speculation this step
        row = self.blocks.table_row(rid, self.runner.max_blocks_per_seq)
        # catch-up prefill of the diverged tail ctx[p:L-1], bucketed
        max_chunk = self.runner.prefill_buckets[-1]
        pos = p
        while pos < L - 1:
            chunk = list(ctx[pos : min(pos + max_chunk, L - 1)])
            self.runner.prefill_chunk(chunk, row, pos)
            pos += len(chunk)
        # greedy draft decode from the last committed token
        drafts: List[int] = []
        tok = int(ctx[L - 1])
        for i in range(k):
            cur = L - 1 + i
            logits = self.runner.decode([tok], [cur], [row], [cur + 1])
            tok = int(np.argmax(logits[0]))
            drafts.append(tok)
        # cache now holds ctx[:L] plus all drafts except the last (whose
        # K/V was never written)
        self._written[rid] = list(ctx[:L]) + drafts[:-1]
        return drafts

    def release(self, request_id: str) -> None:
        rid = request_id or "draft"
        self._written.pop(rid, None)
        self.blocks.free(rid)
