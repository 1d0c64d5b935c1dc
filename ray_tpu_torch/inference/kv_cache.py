"""Paged KV cache management: the host-side block allocator.

vLLM-style paging (PAPERS.md: TPU serving stacks win by packing many
requests into one fixed-shape KV cache): the device holds
``[n_layers, num_blocks, block_size, n_kv_heads, head_dim]`` K and V
tensors (``models.llama.init_paged_kv_cache``); this module owns the
*accounting* — which request holds which block ids, what is free, and
when a new request must wait in the admission queue instead.

Block id 0 is reserved as the NULL block: padding positions in the
fixed-shape prefill/decode steps write their trash there, so it is never
handed to a request. Block ids are layer-agnostic — one id covers
``block_size`` token positions in every layer at once, so the allocator
deals in tokens, not layer-tokens.

Prefix caching (the warm-TTFT tentpole): a FULL block whose token
content has been completely written is immutable from then on — decode
only ever writes positions past it. The manager therefore indexes full
blocks by a *chain digest* (hash of the block's tokens chained with the
previous block's digest — the path-compressed radix tree of vLLM's
automatic prefix caching, stored flat because every node is uniquely
named by its prefix digest). A new request whose prompt prefix matches
cached digests ACQUIRES those blocks (refcounted sharing instead of
re-prefilling) and only the uncached tail goes through prefill.

Copy-on-write covers the one case where a sharer must write into a
shared block: a *full-prompt* hit still needs the last prompt token's
logits, so the final hit block is duplicated device-side
(``model_runner.copy_blocks``) and a 1-token prefill recomputes just
that position into the private copy — the shared original stays
immutable for every other reader.

Eviction: blocks whose refcount drops to zero stay cached (they cost
nothing until the pool is short) on an LRU list; allocation drains the
free list first, then reclaims the oldest unreferenced cached block.
``free_blocks``/``used_blocks`` count cached-but-unreferenced capacity
as free — it is reclaimable at zero cost, and admission control must
see it that way or a warm cache would wedge the queue.

Pure host-side python with no jax dependency: unit-testable without an
accelerator, and cheap enough to run under the engine lock.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

#: digest width for the chain hash. 16 bytes: block-content collisions
#: would silently serve wrong KV, so this is sized for "never", not for
#: compactness — the gossip digest truncates to 8-byte ints instead.
_DIGEST_SIZE = 16


def _chain_digest(prev: bytes, block_tokens) -> bytes:
    """Digest naming the prefix that ends with ``block_tokens``."""
    h = hashlib.blake2b(prev, digest_size=_DIGEST_SIZE)
    h.update(struct.pack(f"<{len(block_tokens)}q", *block_tokens))
    return h.digest()


def prefix_block_hashes(tokens, block_size: int) -> List[int]:
    """Chain digests of every FULL block of ``tokens``, truncated to
    signed 64-bit ints — the compact form replicas gossip to routers and
    routers recompute per request for affinity scoring. Must stay in
    lockstep with the manager's internal chain (same function, truncated
    view), or affinity would never match."""
    out: List[int] = []
    prev = b""
    for end in range(block_size, len(tokens) + 1, block_size):
        prev = _chain_digest(prev, tokens[end - block_size : end])
        out.append(struct.unpack("<q", prev[:8])[0])
    return out


class PagedBlockManager:
    """Allocation / free / eviction accounting for the shared block pool."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        *,
        prefix_cache_enabled: bool = False,
        prefix_cache_max_blocks: int = 0,
    ):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache_enabled = prefix_cache_enabled
        #: cap on indexed blocks (0 = bounded only by the pool itself)
        self.prefix_cache_max_blocks = prefix_cache_max_blocks
        # block 0 = null: never allocated
        self._free: deque = deque(range(1, num_blocks))
        self._owned: Dict[str, List[int]] = {}
        #: block -> number of requests referencing it (shared prefix
        #: blocks count every sharer; COW sources count their pin)
        self._ref: Dict[int, int] = {}
        #: block -> chain digest, for FULL (immutable) cached blocks
        self._block_hash: Dict[int, bytes] = {}
        #: chain digest -> block (the flat radix index). Ordered by
        #: RECENCY OF USE (insertion + move-to-end on every hit): the
        #: gossip digest truncates to the most recent entries, and a hot
        #: shared system prompt must stay inside that window no matter
        #: how long ago it was first indexed.
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        #: chain digest -> PARENT chain digest (b"" at the root): the
        #: radix-path structure the flat index erases. Gossip export
        #: walks these so every exported digest ships with its whole
        #: ancestor spine — a consecutive-prefix matcher (the router)
        #: can't use an orphan digest whose ancestors were truncated out.
        self._parent: Dict[bytes, bytes] = {}
        #: unreferenced cached blocks, oldest first (block -> digest)
        self._lru: "OrderedDict[int, bytes]" = OrderedDict()
        #: request -> COW source blocks pinned until the device copy ran
        self._cow_src: Dict[str, List[int]] = {}
        #: chain digest -> acquire_prefix hit count (the popularity
        #: signal the spill-vs-drop policy reads at eviction)
        self._hits: Dict[bytes, int] = {}
        #: spill-vs-drop policy hook: ``fn(digest, block, hits) -> bool``
        #: consulted at EVERY indexed-block eviction (allocation-pressure
        #: LRU reclaim and the register cap-eviction — one policy point,
        #: not two divergent code paths). True = the block's content was
        #: spilled somewhere recoverable (the cluster KV tier), False =
        #: dropped. Runs under the manager lock on the step thread: the
        #: hook may read the device (the content dies with the return)
        #: but MUST NOT re-enter locked manager methods or block on IO.
        self._spill_hook = None
        self._lock = threading.Lock()
        # lifetime accounting (engine /metrics + stats())
        self.total_allocs = 0
        self.total_frees = 0
        self.total_evictions = 0
        self.prefix_queries_total = 0
        self.prefix_hits_total = 0
        self.prefix_tokens_saved_total = 0
        self.cow_copies_total = 0
        self.prefix_evictions_total = 0
        #: books-balance split of prefix_evictions_total: every evicted
        #: indexed block is EXACTLY one of spilled (content preserved in
        #: the tier) or dropped (gone) — evictions == spilled + dropped
        self.prefix_spilled_total = 0
        self.prefix_dropped_total = 0

    def set_spill_hook(self, hook) -> None:
        """Install the spill-vs-drop policy (see ``_spill_hook``)."""
        with self._lock:
            self._spill_hook = hook

    # -- capacity ---------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus the null block

    @property
    def free_blocks(self) -> int:
        """Immediately-allocatable capacity: the free list plus cached
        blocks no live request references (reclaimed on demand)."""
        with self._lock:
            return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Unreferenced blocks held only by the prefix cache."""
        with self._lock:
            return len(self._lru)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - self.free_blocks

    def utilization(self) -> float:
        return self.used_blocks / max(1, self.usable_blocks)

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return max(1, -(-num_tokens // self.block_size))  # ceil

    # -- allocation -------------------------------------------------------
    def owned(self, request_id: str) -> List[int]:
        with self._lock:
            return list(self._owned.get(request_id, ()))

    def _evict_indexed_locked(self, blk: int, digest: bytes) -> None:
        """Retire one indexed block from the radix structure — the ONE
        spill-vs-drop policy decision point (LRU eviction and the
        kv_transfer export path share it, so KV pressure never silently
        destroys reusable state).
        The hook sees the block while its device content is still valid
        and decides: spill (preserve in the tier) or drop."""
        del self._index[digest]
        del self._block_hash[blk]
        self._parent.pop(digest, None)
        hits = self._hits.pop(digest, 0)
        self.prefix_evictions_total += 1
        spilled = False
        if self._spill_hook is not None:
            try:
                spilled = bool(self._spill_hook(digest, blk, hits))
            except Exception:
                spilled = False  # a broken policy degrades to drop
        if spilled:
            self.prefix_spilled_total += 1
        else:
            self.prefix_dropped_total += 1

    def _take_block_locked(self) -> Optional[int]:
        """One free block, reclaiming the LRU cached block if needed."""
        if self._free:
            return self._free.popleft()
        if self._lru:
            blk, digest = self._lru.popitem(last=False)
            self._evict_indexed_locked(blk, digest)
            return blk
        return None

    def _release_block_locked(self, blk: int) -> None:
        """Drop one reference; park the block on the LRU (still cached)
        or the free list once nobody references it."""
        n = self._ref.get(blk, 1) - 1
        if n > 0:
            self._ref[blk] = n
            return
        self._ref.pop(blk, None)
        digest = self._block_hash.get(blk)
        if digest is not None:
            self._lru[blk] = digest
            self._lru.move_to_end(blk)
        else:
            self._free.append(blk)

    def can_grow_to(self, request_id: str, num_tokens: int) -> bool:
        """Whether the pool can extend ``request_id`` to cover
        ``num_tokens`` total positions (no allocation happens)."""
        need = self.blocks_for_tokens(num_tokens)
        with self._lock:
            have = len(self._owned.get(request_id, ()))
            return need - have <= len(self._free) + len(self._lru)

    def grow_to(self, request_id: str, num_tokens: int) -> bool:
        """Extend the request's block list to cover ``num_tokens`` total
        positions. All-or-nothing: returns False (nothing allocated) when
        the free pool can't cover the extension."""
        need = self.blocks_for_tokens(num_tokens)
        with self._lock:
            blocks = self._owned.setdefault(request_id, [])
            missing = need - len(blocks)
            if missing <= 0:
                return True
            if missing > len(self._free) + len(self._lru):
                if not blocks:
                    self._owned.pop(request_id, None)
                return False
            for _ in range(missing):
                blk = self._take_block_locked()
                blocks.append(blk)
                self._ref[blk] = 1
            self.total_allocs += missing
            return True

    def trim_to(self, request_id: str, num_tokens: int) -> int:
        """Shrink the request's block list back to exactly cover
        ``num_tokens`` total positions — the speculative-decode rollback:
        blocks grown for rejected draft positions are handed back before
        any other request could observe them. Refcount-aware like
        :meth:`free` (a trimmed block some other holder still references
        just drops this request's pin), though in the speculative path
        trimmed tails are always freshly grown (ref==1, never indexed)
        so they go straight back to the free list. Returns the number of
        block references released."""
        keep = self.blocks_for_tokens(num_tokens)
        with self._lock:
            blocks = self._owned.get(request_id)
            if not blocks or len(blocks) <= keep:
                return 0
            released = 0
            while len(blocks) > keep:
                self._release_block_locked(blocks.pop())
                released += 1
            self.total_frees += released
            return released

    def free(self, request_id: str) -> int:
        """Release every block the request holds (refcount-aware: shared
        blocks survive for their other holders). Returns the number of
        block references released."""
        with self._lock:
            blocks = self._owned.pop(request_id, [])
            for blk in blocks:
                self._release_block_locked(blk)
            # a pending COW that never executed releases its source pin
            for blk in self._cow_src.pop(request_id, ()):
                self._release_block_locked(blk)
            self.total_frees += len(blocks)
            return len(blocks)

    def evict(self, request_id: str) -> int:
        """Free-with-attitude: same as :meth:`free` but counted as a
        preemption eviction (the scheduler took the blocks away; the
        request re-prefills on readmission)."""
        n = self.free(request_id)
        if n:
            self.total_evictions += 1
        return n

    # -- prefix cache -----------------------------------------------------
    def acquire_prefix(
        self, request_id: str, tokens
    ) -> Tuple[int, List[Tuple[int, int]]]:
        """Attach cached blocks covering the longest indexed prefix of
        ``tokens`` to ``request_id``; returns ``(cached_tokens,
        cow_pairs)``. The request's prefill then starts at
        ``cached_tokens`` instead of 0.

        A FULL-prompt hit keeps the final block shared but pairs it with
        a freshly allocated private copy target: ``cow_pairs`` =
        ``[(src, dst)]`` for the engine to execute device-side before
        the 1-token tail prefill writes position ``len(tokens)-1`` into
        ``dst``. The source stays refcount-pinned until
        :meth:`cow_copied` (or :meth:`free`) — without the pin, another
        admission in the same scheduling pass could reclaim it before
        the copy ran. Does NOT bump the hit counters — the scheduler
        commits them via :meth:`note_prefix_hit` only once admission
        (block growth for the tail) actually succeeds, so a stuck queue
        head retrying every tick doesn't inflate the stats.
        """
        if not self.prefix_cache_enabled:
            return 0, []
        with self._lock:
            if self._owned.get(request_id):
                return 0, []  # mid-flight request: table already live
            hits: List[int] = []
            prev = b""
            bs = self.block_size
            for end in range(bs, len(tokens) + 1, bs):
                prev = _chain_digest(prev, tokens[end - bs : end])
                blk = self._index.get(prev)
                if blk is None:
                    break
                # refresh use-recency so hot prefixes stay in the
                # truncated gossip digest window
                self._index.move_to_end(prev)
                # popularity signal for the eviction-time spill-vs-drop
                # decision ("spill popular, drop cold")
                self._hits[prev] = self._hits.get(prev, 0) + 1
                hits.append(blk)
            if not hits:
                return 0, []
            # pin every hit FIRST: an unreferenced hit sits on the LRU
            # and a subsequent allocation in this same pass could
            # otherwise reclaim it out from under us
            for blk in hits:
                self._ref[blk] = self._ref.get(blk, 0) + 1
                self._lru.pop(blk, None)
            cow: List[Tuple[int, int]] = []
            cached_tokens = len(hits) * bs
            if cached_tokens >= len(tokens):
                # full-prompt hit: the first sampled token needs the last
                # prompt token's logits, so ONE token must still prefill
                # — and its K/V write lands inside the final (shared)
                # block. COW that block to a private copy; the tail
                # prefill recomputes position len-1 into the copy.
                dst = self._take_block_locked()
                if dst is None:
                    # pool dry: fall back to recomputing the last block
                    self._release_block_locked(hits.pop())
                    cached_tokens -= bs
                else:
                    src = hits[-1]
                    hits[-1] = dst
                    self._ref[dst] = 1
                    # src keeps the pin taken above, now owned by the
                    # pending-copy record instead of the block table
                    self._cow_src.setdefault(request_id, []).append(src)
                    cow.append((src, dst))
                    self.cow_copies_total += 1
                    self.total_allocs += 1
                    cached_tokens = len(tokens) - 1
            if not hits:
                return 0, []
            self._owned[request_id] = hits
            return cached_tokens, cow

    def note_prefix_hit(self, cached_tokens: int) -> None:
        """Commit hit accounting once the request actually ADMITTED —
        one query per admission, not per acquire attempt (a queue head
        stuck behind block pressure re-acquires every scheduler tick and
        would otherwise drown the hit rate in retry noise). No-op with
        the cache disabled: queries_total must read as "admissions with
        the cache ON", not tick up under a 0.0 hit rate."""
        if not self.prefix_cache_enabled:
            return
        with self._lock:
            self.prefix_queries_total += 1
            if cached_tokens <= 0:
                return
            self.prefix_hits_total += 1
            self.prefix_tokens_saved_total += cached_tokens

    def cow_copied(self, request_id: str) -> None:
        """The engine executed the pending device copies: release the
        source pins (the private copies live in the block table now)."""
        with self._lock:
            for blk in self._cow_src.pop(request_id, ()):
                self._release_block_locked(blk)

    def register_prefix(self, request_id: str, tokens) -> int:
        """Index the request's fully-written blocks: ``tokens`` must be
        the positions whose K/V are actually in the cache (the prompt at
        prefill completion; prompt+generated-minus-one at finish — the
        final sampled token's K/V is never written). Full blocks are
        immutable from here on, so indexing them is safe for any future
        reader. Returns how many new blocks were indexed."""
        if not self.prefix_cache_enabled:
            return 0
        with self._lock:
            blocks = self._owned.get(request_id)
            if not blocks:
                return 0
            bs = self.block_size
            n_full = min(len(tokens) // bs, len(blocks))
            added = 0
            prev = b""
            for i in range(n_full):
                parent = prev
                prev = _chain_digest(prev, tokens[i * bs : (i + 1) * bs])
                blk = blocks[i]
                if blk in self._block_hash:
                    continue  # already indexed (e.g. acquired via a hit)
                if prev in self._index:
                    continue  # another block already serves this prefix
                if self.prefix_cache_max_blocks > 0 and (
                    len(self._index) >= self.prefix_cache_max_blocks
                ):
                    if not self._lru:
                        break  # cap reached, nothing evictable
                    old_blk, old_digest = self._lru.popitem(last=False)
                    self._evict_indexed_locked(old_blk, old_digest)
                    self._free.append(old_blk)
                self._block_hash[blk] = prev
                self._index[prev] = blk
                self._parent[prev] = parent
                added += 1
            return added

    def prefix_digest(self, max_entries: int = 256) -> List[int]:
        """Compact cache summary for router gossip: a bounded
        RADIX-PATH export instead of the old flat recent-N slice.

        The router's affinity scorer matches consecutively from block 0
        and stops at the first miss, so an exported digest is only
        usable when its entire ancestor chain is exported with it. The
        flat MRU slice broke exactly that once the index outgrew the
        budget: it kept the N most-recently-used blocks as arbitrary
        points, truncating the ancestors a deep hot path needs. Here we
        walk the index MRU-first and export whole root-anchored SPINES
        (each digest plus every ancestor still indexed), skipping spines
        that don't fit the remaining budget or whose chain is broken by
        eviction (their descendants can never match anyway) — so with
        >10k indexed blocks the gossip covers the hottest complete
        paths, not a useless frontier of orphans.

        Truncation contract (unchanged): entries are the first 8 bytes
        of the 16-byte chain digest as signed 64-bit ints. A router-side
        collision is a FALSE POSITIVE ONLY — it routes a request to a
        replica that turns out cold, costing one suboptimal placement;
        correctness never depends on this digest (the engine re-derives
        full 16-byte digests at admission)."""
        out: List[bytes] = []
        with self._lock:
            seen = set()
            for digest in reversed(self._index):
                if len(out) >= max_entries:
                    break
                if digest in seen:
                    continue  # already exported as an ancestor
                spine: List[bytes] = []
                d = digest
                complete = True
                while d:
                    if d in seen:
                        break  # ancestors already in the export
                    if d not in self._index:
                        complete = False  # evicted mid-chain: orphan path
                        break
                    spine.append(d)
                    d = self._parent.get(d, b"")
                if not complete or len(out) + len(spine) > max_entries:
                    continue
                seen.update(spine)
                out.extend(spine)
        return [struct.unpack("<q", d[:8])[0] for d in out]

    # -- KV-cache migration (disaggregated serving) -----------------------
    def reserve_import(self, num_blocks: int) -> Optional[List[int]]:
        """Allocate blocks for migrated KV content, each pinned (ref=1)
        until :meth:`commit_import` or :meth:`abort_import` — the device
        scatter runs between reserve and commit, and an unpinned block
        could be reclaimed out from under it. Returns None (nothing
        taken) when the pool can't cover the import — the caller falls
        back to a plain prefill instead of wedging admission."""
        with self._lock:
            if num_blocks <= 0:
                return []
            if num_blocks > len(self._free) + len(self._lru):
                return None
            out: List[int] = []
            for _ in range(num_blocks):
                blk = self._take_block_locked()
                self._ref[blk] = 1
                out.append(blk)
            self.total_allocs += num_blocks
            return out

    def commit_import(self, blocks: List[int], tokens) -> int:
        """Index scattered import blocks in the radix structure so later
        admissions (the migrated request first of all) acquire them as
        prefix hits. Block i must hold the K/V of
        ``tokens[i*bs:(i+1)*bs]`` — the chain digest is recomputed here
        from the tokens, never trusted from the wire. Blocks whose
        prefix another local block already serves are redundant copies:
        released straight back to the free list. Every committed block
        drops its import pin and parks cached-unreferenced (LRU), i.e.
        imported KV costs nothing until someone uses or evicts it.
        Returns the number of blocks actually indexed."""
        bs = self.block_size
        n = min(len(blocks), len(tokens) // bs)
        added = 0
        with self._lock:
            prev = b""
            for i in range(n):
                parent = prev
                prev = _chain_digest(prev, tokens[i * bs : (i + 1) * bs])
                blk = blocks[i]
                if prev in self._index or blk in self._block_hash:
                    # an equivalent block is already indexed locally:
                    # drop the imported copy (no digest -> free list)
                    self._release_block_locked(blk)
                    continue
                self._block_hash[blk] = prev
                self._index[prev] = blk
                self._parent[prev] = parent
                # pin released WITH the digest set: lands on the LRU as
                # a cached-unreferenced block
                self._release_block_locked(blk)
                added += 1
            # surplus reserve (shouldn't happen: caller sizes exactly)
            for blk in blocks[n:]:
                self._release_block_locked(blk)
        return added

    def abort_import(self, blocks: List[int]) -> None:
        """Scatter failed: return reserved (never-indexed) blocks."""
        with self._lock:
            for blk in blocks:
                self._release_block_locked(blk)

    def prefix_stats(self) -> Dict[str, float]:
        with self._lock:
            indexed = len(self._index)
            cached_free = len(self._lru)
            queries = self.prefix_queries_total
            hits = self.prefix_hits_total
        return {
            "enabled": self.prefix_cache_enabled,
            "indexed_blocks": indexed,
            "cached_unreferenced_blocks": cached_free,
            # queries = ADMISSIONS with the cache enabled (see
            # note_prefix_hit), so hit_rate reads as "fraction of
            # admitted requests that reused cached blocks"
            "queries_total": queries,
            "hits_total": hits,
            "hit_rate": hits / queries if queries else 0.0,
            "tokens_saved_total": self.prefix_tokens_saved_total,
            "cow_copies_total": self.cow_copies_total,
            "evictions_total": self.prefix_evictions_total,
            # spill-vs-drop books: evictions == spilled + dropped, always
            "spilled_total": self.prefix_spilled_total,
            "dropped_total": self.prefix_dropped_total,
        }

    # -- introspection ----------------------------------------------------
    def refcount(self, block_id: int) -> int:
        with self._lock:
            return self._ref.get(block_id, 0)

    def table_row(self, request_id: str, max_blocks: int) -> List[int]:
        """The request's block-table row, right-padded with the null
        block to the fixed ``max_blocks`` width the jitted steps expect."""
        blocks = self.owned(request_id)
        if len(blocks) > max_blocks:
            raise ValueError(
                f"request {request_id!r} holds {len(blocks)} blocks > "
                f"max_blocks_per_seq {max_blocks}"
            )
        return blocks + [0] * (max_blocks - len(blocks))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            free = len(self._free) + len(self._lru)
            cached = len(self._lru)
            holders = len(self._owned)
        used = self.usable_blocks - free
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "used_blocks": used,
            "free_blocks": free,
            "prefix_cached_blocks": cached,
            "holders": holders,
            "utilization": used / max(1, self.usable_blocks),
            "total_allocs": self.total_allocs,
            "total_frees": self.total_frees,
            "total_evictions": self.total_evictions,
        }
