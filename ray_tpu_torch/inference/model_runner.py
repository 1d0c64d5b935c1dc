"""Bucketed prefill/decode/verify steps over the paged KV cache (port of
``ray_tpu.inference.model_runner``).

The runner rounds every prefill chunk up to a length bucket and every
decode batch up to a size bucket, exactly as the reference does for XLA's
one-program-per-shape compile cache. The port runs the steps eagerly, so
a "compile" is the first run of a (kind, bucket) shape: the runner counts
shape signatures, which is the reference's own fallback count
(``_seen_shapes``), and after warmup the engine must see zero new ones
(``recompiles_after_warmup``).

The cache lives on the params' device and is updated in place by every
step (the port's counterpart of donation); there is one cache for the
runner's lifetime. Inputs are built on the host in numpy, as in the
reference, and copied to the device once per call; logits come back to
numpy once per call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.llama import (
    LlamaConfig,
    copy_paged_blocks,
    gather_paged_blocks,
    init_paged_kv_cache,
    paged_decode_step,
    paged_prefill_step,
    paged_verify_step,
    scatter_paged_blocks,
)

#: block-copy pairs per COW program (pairs pad with null->null)
_COW_WIDTH = 4

#: blocks per KV gather/scatter program (KV-cache migration); short
#: chunks pad with the null block so the shape never varies
_KV_IO_WIDTH = 8


def _round_up_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class PagedModelRunner:
    def __init__(
        self,
        cfg: LlamaConfig,
        params,
        *,
        num_blocks: int,
        block_size: int,
        prefill_buckets: Sequence[int],
        decode_buckets: Sequence[int],
        verify_buckets: Sequence[int] = (),
        cache_dtype=None,
    ):
        self.cfg = cfg
        self.params = params
        #: every step runs where the params live, from whichever thread
        self.device = params.embed.device
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.decode_buckets = tuple(sorted(decode_buckets))
        #: speculative-verify window buckets (k+1 positions per step);
        #: empty unless the engine enables speculation, so plain
        #: deployments keep their exact compile_count
        self.verify_buckets = tuple(sorted(verify_buckets))
        #: fixed block-table width every request/table row pads to
        self.max_blocks_per_seq = -(-cfg.max_seq_len // block_size)
        if num_blocks - 1 < self.max_blocks_per_seq:
            raise ValueError(
                f"num_blocks={num_blocks} can't hold one max-length sequence "
                f"({self.max_blocks_per_seq} blocks + null block)"
            )
        self.cache = init_paged_kv_cache(cfg, num_blocks, block_size, cache_dtype,
                                         device=self.device)
        #: the cache's element type by name ("bfloat16", "float32", ...):
        #: a KV payload names it, and an importer matches it
        self.kv_dtype = str(self.cache["k"].dtype).removeprefix("torch.")
        #: the numpy type :meth:`gather_blocks` returns and
        #: :meth:`scatter_blocks` takes: bf16, which numpy lacks, as its
        #: bits (``uint16``); one host type per cache type
        self.kv_host_dtype = _to_numpy(self.cache["k"].new_zeros(0)).dtype
        self._seen_shapes: set = set()
        self._warmup_compiles: Optional[int] = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host int array → long tensor on the params' device."""
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device, non_blocking=True)

    # -- compile accounting ----------------------------------------------
    def mark_warm(self) -> None:
        """Call after warmup: new shapes past this point are regressions."""
        self._warmup_compiles = len(self._seen_shapes)

    def recompiles_after_warmup(self) -> int:
        if self._warmup_compiles is None:
            return 0
        return max(0, len(self._seen_shapes) - self._warmup_compiles)

    def compile_count(self) -> int:
        return len(self._seen_shapes)

    def warmup(
        self, buckets_prefill=None, buckets_decode=None, *, kv_io: bool = False
    ) -> None:
        """Run every (or the given) bucket once up front with trash inputs
        aimed at the null block, then :meth:`mark_warm`. ``kv_io`` also
        runs the KV-migration gather/scatter shapes."""
        M = self.max_blocks_per_seq
        decode = buckets_decode if buckets_decode is not None else self.decode_buckets
        for c in buckets_prefill if buckets_prefill is not None else self.prefill_buckets:
            paged_prefill_step(self.cfg, self.params, self.cache, self._dev(np.zeros(c)),
                               self._dev(np.zeros(M)), 0, 0)
            self._seen_shapes.add(("p", c))
        for b in decode:
            paged_decode_step(self.cfg, self.params, self.cache, self._dev(np.zeros(b)),
                              self._dev(np.zeros(b)), self._dev(np.zeros((b, M))),
                              self._dev(np.ones(b)))
            self._seen_shapes.add(("d", b))
        # speculative-verify windows, only when the engine opted in: every
        # (batch bucket, window bucket) pair a live engine can issue
        for c in self.verify_buckets:
            for b in decode:
                paged_verify_step(self.cfg, self.params, self.cache,
                                  self._dev(np.zeros((b, c))), self._dev(np.zeros((b, M))),
                                  self._dev(np.zeros(b)), self._dev(np.zeros(b)))
                self._seen_shapes.add(("v", b, c))
        pad = self._dev(np.zeros(_COW_WIDTH))
        copy_paged_blocks(self.cache, pad, pad)
        self._seen_shapes.add(("c", _COW_WIDTH))
        if kv_io:
            ids = np.zeros(_KV_IO_WIDTH, np.int64)
            self.scatter_blocks(ids, self.gather_blocks(ids))
        self.mark_warm()

    # -- steps ------------------------------------------------------------
    def copy_blocks(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Block duplication (prefix-cache COW): each ``(src, dst)`` pair
        copies one whole block across every layer, ``_COW_WIDTH`` pairs a
        call, short chunks padded with null->null pairs."""
        for i in range(0, len(pairs), _COW_WIDTH):
            chunk = pairs[i : i + _COW_WIDTH]
            src = np.zeros(_COW_WIDTH, np.int64)
            dst = np.zeros(_COW_WIDTH, np.int64)
            for j, (s, d) in enumerate(chunk):
                src[j], dst[j] = s, d
            self._seen_shapes.add(("c", _COW_WIDTH))
            copy_paged_blocks(self.cache, self._dev(src), self._dev(dst))

    def gather_blocks(self, block_ids: Sequence[int]) -> np.ndarray:
        """Whole cache blocks to the host: ``[2, n_layers, len(block_ids),
        block_size, n_kv, head_dim]`` in :attr:`kv_host_dtype` (numpy;
        bf16 as its bits, ``np.uint16``), in ``_KV_IO_WIDTH`` chunks
        padded with the null block, padding rows sliced off."""
        outs = []
        for i in range(0, len(block_ids), _KV_IO_WIDTH):
            chunk = block_ids[i : i + _KV_IO_WIDTH]
            ids = np.zeros(_KV_IO_WIDTH, np.int64)
            ids[: len(chunk)] = chunk
            self._seen_shapes.add(("g", _KV_IO_WIDTH))
            out = gather_paged_blocks(self.cache, self._dev(ids))[:, :, : len(chunk)]
            outs.append(_to_numpy(out))
        if not outs:
            L, _, bs, kv, hd = self.cache["k"].shape
            return _to_numpy(self.cache["k"].new_zeros((2, L, 0, bs, kv, hd)))
        return np.concatenate(outs, axis=2) if len(outs) > 1 else outs[0]

    def scatter_blocks(self, block_ids: Sequence[int], kv: np.ndarray) -> None:
        """Write blocks in the :meth:`gather_blocks` layout into this cache,
        one row per id; short chunks pad with the null block. ``kv`` must
        be in :attr:`kv_host_dtype`: a payload of another type (bf16 bits
        for an f32 cache, f32 values for a bf16 one) raises instead of
        being converted. Each chunk is packed into a fresh host buffer and
        copied to the device before the next, so ``kv`` may be a view of
        memory the caller unmaps as soon as this returns."""
        if kv.dtype != self.kv_host_dtype:
            raise TypeError(
                f"KV payload of {kv.dtype} cannot be scattered into a {self.kv_dtype} "
                f"cache (expects {self.kv_host_dtype})")
        for i in range(0, len(block_ids), _KV_IO_WIDTH):
            chunk = block_ids[i : i + _KV_IO_WIDTH]
            ids = np.zeros(_KV_IO_WIDTH, np.int64)
            ids[: len(chunk)] = chunk
            buf = np.zeros(kv.shape[:2] + (_KV_IO_WIDTH,) + kv.shape[3:], kv.dtype)
            buf[:, :, : len(chunk)] = kv[:, :, i : i + len(chunk)]
            self._seen_shapes.add(("s", _KV_IO_WIDTH))
            scatter_paged_blocks(self.cache, self._dev(ids), _from_numpy(buf).to(self.device))

    def prefill_chunk(self, tokens: Sequence[int], block_row: Sequence[int],
                      ctx_len: int) -> np.ndarray:
        """Run one prefill chunk; returns logits [vocab] (f32 numpy) for the
        chunk's last valid token."""
        true_len = len(tokens)
        bucket = _round_up_bucket(true_len, self.prefill_buckets)
        padded = np.zeros(bucket, np.int64)
        padded[:true_len] = tokens
        self._seen_shapes.add(("p", bucket))
        logits = paged_prefill_step(self.cfg, self.params, self.cache, self._dev(padded),
                                    self._dev(block_row), int(ctx_len), true_len)
        return logits.cpu().numpy()

    def verify_batch(self, windows: Sequence[Sequence[int]],
                     block_rows: Sequence[Sequence[int]],
                     ctx_lens: Sequence[int]) -> List[np.ndarray]:
        """Run speculative-verify windows (``[last_committed, d_1..d_k]``
        each) for a batch of slots in ONE step. Returns one logits array
        [len(window), vocab] (f32 numpy) per slot. The batch pads to a
        decode bucket; padding slots carry ``true_len=0``."""
        n = len(windows)
        cbucket = _round_up_bucket(max(len(w) for w in windows), self.verify_buckets)
        bbucket = _round_up_bucket(n, self.decode_buckets)
        M = self.max_blocks_per_seq
        tokens = np.zeros((bbucket, cbucket), np.int64)
        tables = np.zeros((bbucket, M), np.int64)
        ctx = np.zeros(bbucket, np.int64)
        tl = np.zeros(bbucket, np.int64)
        for i, w in enumerate(windows):
            tokens[i, : len(w)] = w
            tables[i] = block_rows[i]
            ctx[i] = ctx_lens[i]
            tl[i] = len(w)
        self._seen_shapes.add(("v", bbucket, cbucket))
        logits = paged_verify_step(self.cfg, self.params, self.cache, self._dev(tokens),
                                   self._dev(tables), self._dev(ctx), self._dev(tl))
        out = logits.cpu().numpy()
        return [out[i, : len(w)] for i, w in enumerate(windows)]

    def decode(self, tokens: Sequence[int], positions: Sequence[int],
               block_rows: Sequence[Sequence[int]], ctx_lens: Sequence[int]) -> np.ndarray:
        """Advance a decode batch one token; returns logits [n, vocab] for
        the n REAL slots (padding stripped)."""
        n = len(tokens)
        bucket = _round_up_bucket(n, self.decode_buckets)
        M = self.max_blocks_per_seq
        t = np.zeros(bucket, np.int64)
        p = np.zeros(bucket, np.int64)
        bt = np.zeros((bucket, M), np.int64)
        cl = np.ones(bucket, np.int64)  # padding slots: ctx=1 over the null block
        t[:n] = tokens
        p[:n] = positions
        bt[:n] = np.asarray(block_rows, np.int64)
        cl[:n] = ctx_lens
        self._seen_shapes.add(("d", bucket))
        logits = paged_decode_step(self.cfg, self.params, self.cache, self._dev(t), self._dev(p),
                                   self._dev(bt), self._dev(cl))
        return logits.cpu().numpy()[:n]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bf16 (which numpy lacks) travels as its bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`_to_numpy`: ``uint16`` is bf16's bits."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)
