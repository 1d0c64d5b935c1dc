"""Sequence-parallel attention: ring attention + Ulysses all-to-all (port of
``ray_tpu.ops.ring_attention``).

* **Ring attention** (``ring_attention`` / ``ring_attention_sharded``):
  Q stays put; K/V chunks rotate around the ``seq`` axis's process group
  (``dist.batch_isend_irecv`` to the previous rank, from the next) while
  each chunk's partial attention is merged into the running
  online-softmax state (m, l, acc). The S x S score matrix never exists:
  per rank the working set is O(S_local^2) per chunk. The chunk products
  are f32 einsums, as in the JAX function (no Pallas kernel there), so the
  ring launches none of the flash kernels.

* **Ulysses** (``ulysses_attention`` / ``ulysses_attention_sharded``): one
  all-to-all swaps the sharded axis from sequence to heads, each rank runs
  the port's ``flash_attention`` (the Hopper kernels on CUDA tensors) on
  full sequences for its head subset, and a second all-to-all swaps back.
  Two all-to-alls against the ring's n-1 rotations, but the seq-parallel
  degree is capped by the head count.

Both are differentiable: the rotation is an ``autograd.Function`` whose
backward rotates the gradient the other way, each chunk's merge runs under
``torch.utils.checkpoint`` (the JAX ``merge_chunk`` is
``jax.checkpoint``-ed) so the backward recomputes chunk scores instead of
storing them, with the rotation outside the checkpointed function so a
recompute never issues a send or receive; the all-to-all is
``torch.distributed.nn.functional.all_to_all_single``, which has autograd.

The ``*_sharded`` wrappers apply ``shard_map_compat`` over the canonical
mesh axes (batch over data/fsdp, heads over tensor, sequence over seq), so
callers hand in DTensors, or plain full tensors, in the JAX layout
``[batch, heads, seq, head_dim]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.parallel.comm import RingShift
from ray_tpu_torch.parallel.mesh import DATA, FSDP, SEQUENCE, TENSOR, shard_map_compat
from ray_tpu_torch.parallel.sharding import PartitionSpec as P

_NEG_INF = -1e30


def _chunk_attention(q, k, v, q_offset: int, k_offset: int, *, causal: bool, sm_scale: float):
    """Partial attention of a local Q block against one K/V chunk.

    q: ``[b, h, sq, d]``; k/v: ``[b, h, sk, d]``. Returns the unnormalised
    accumulator pv = P.V (f32), the row max m and row sum l of the masked,
    max-shifted scores: the online-softmax sufficient stats."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        q_pos = q_offset + torch.arange(sq, device=s.device)[:, None]
        k_pos = k_offset + torch.arange(sk, device=s.device)[None, :]
        mask = q_pos >= k_pos
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # [b, h, sq, 1]
    p = torch.exp(s - m)
    if causal:
        # a row with every position masked has m == -1e30 and would
        # otherwise get p == exp(0) == 1 on the masked entries
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return pv, m, l


def _merge(acc, m, l, pv_i, m_i, l_i):
    """Merge one chunk's stats into the running online-softmax state."""
    m_new = torch.maximum(m, m_i)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_i - m_new)
    return acc * alpha + pv_i * beta, m_new, l * alpha + l_i * beta


def ring_attention(
    q,
    k,
    v,
    *,
    group=None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    kv_repeat: int = 1,
):
    """Ring attention over the sequence-sharded process ``group`` (the
    ``seq`` axis's; the default group when None).

    q: ``[b, h, s_local, d]``; k/v: ``[b, h // kv_repeat, s_local, d]``,
    each rank's shard of the sequence: group rank i holds global positions
    ``[i*s_local, (i+1)*s_local)``. GQA: pass the unrepeated K/V plus
    ``kv_repeat``; the small KV heads rotate and are repeated locally per
    chunk. n ranks: n chunk merges and n-1 rotations (the last chunk
    received is merged in place)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    b, h, s_loc, d = q.shape
    q32 = q.float()
    q_offset = my_idx * s_loc

    def rep(x):
        return x.repeat_interleave(kv_repeat, dim=1) if kv_repeat > 1 else x

    def merge_chunk(acc, m, l, kc, vc, k_offset):
        pv_i, m_i, l_i = _chunk_attention(q32, rep(kc), rep(vc), q_offset, k_offset,
                                          causal=causal, sm_scale=sm_scale)
        return _merge(acc, m, l, pv_i, m_i, l_i)

    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for t in range(n):
        if t < n - 1:  # the next chunk's rotation, outside the checkpoint
            kn, vn = RingShift.apply(group, -1, kc, vc)  # from the next rank
        k_offset = ((my_idx + t) % n) * s_loc
        acc, m, l = checkpoint(merge_chunk, acc, m, l, kc, vc, k_offset, use_reentrant=False)
        if t < n - 1:
            kc, vc = kn, vn
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _spec(batch_axes, head_axis, seq_axis):
    return P(tuple(batch_axes), head_axis, seq_axis, None)


def ring_attention_sharded(
    q,
    k,
    v,
    mesh,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    kv_repeat: int = 1,
    seq_axis: str = SEQUENCE,
    batch_axes: Tuple[str, ...] = (DATA, FSDP),
    head_axis: str = TENSOR,
):
    """Global entry point: ``shard_map_compat`` of the ring over ``mesh``.

    q: ``[batch, heads, seq, head_dim]``; k/v may carry fewer (KV) heads
    with ``kv_repeat`` set (GQA). Batch rides the data/fsdp axes, heads the
    tensor axis, sequence the seq axis."""
    spec = _spec(batch_axes, head_axis, seq_axis)

    def local(q, k, v, *, groups):
        return ring_attention(q, k, v, group=groups[seq_axis], causal=causal,
                              sm_scale=sm_scale, kv_repeat=kv_repeat)

    return shard_map_compat(local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)


def _all_to_all(x, group):
    """``x [n, ...]``: chunk j goes to group rank j, chunk i of the result
    came from group rank i."""
    from torch.distributed.nn.functional import all_to_all_single

    return all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention(
    q,
    k,
    v,
    *,
    group=None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
):
    """Ulysses (DeepSpeed-style) sequence parallelism over ``group``.

    q/k/v: ``[b, h, s_local, d]``, each rank's sequence shard. An all-to-all
    redistributes from sequence-sharded to head-sharded, ``flash_attention``
    runs on the full sequence for h/n heads, and the inverse all-to-all
    restores sequence sharding. Requires ``h % n == 0``. KV heads divisible
    by n are exchanged unrepeated and their GQA groups stay whole on each
    rank (the kernels map q heads to kv heads); otherwise K/V are repeated
    to h heads first."""
    n = dist.get_world_size(group)
    b, h, s_loc, d = q.shape
    h_kv = k.shape[1]
    if h % n != 0:
        raise ValueError(f"ulysses needs heads ({h}) divisible by seq-parallel degree ({n})")
    kv_repeat = h // h_kv

    def seq_to_heads(x):  # [b, hx, s_loc, d] -> [b, hx/n, n*s_loc, d]
        hx = x.shape[1]
        x = x.reshape(b, n, hx // n, s_loc, d).permute(1, 0, 2, 3, 4).contiguous()
        x = _all_to_all(x, group)  # [n (seq shard), b, hx/n, s_loc, d]
        return x.permute(1, 2, 0, 3, 4).reshape(b, hx // n, n * s_loc, d)

    def heads_to_seq(x):  # [b, h/n, n*s_loc, d] -> [b, h, s_loc, d]
        x = x.reshape(b, h // n, n, s_loc, d).permute(2, 0, 1, 3, 4).contiguous()
        x = _all_to_all(x, group)  # [n (head group), b, h/n, s_loc, d]
        return x.permute(1, 0, 2, 3, 4).reshape(b, h, s_loc, d)

    qh = seq_to_heads(q)
    if h_kv % n == 0:
        kh, vh = seq_to_heads(k), seq_to_heads(v)
    else:  # too few KV heads to split n ways: repeat first (full volume)
        kh = seq_to_heads(k.repeat_interleave(kv_repeat, dim=1))
        vh = seq_to_heads(v.repeat_interleave(kv_repeat, dim=1))
    o = flash_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale, impl=impl)
    return heads_to_seq(o)


def ulysses_attention_sharded(
    q,
    k,
    v,
    mesh,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    seq_axis: str = SEQUENCE,
    batch_axes: Tuple[str, ...] = (DATA, FSDP),
    head_axis: str = TENSOR,
    impl: str = "auto",
):
    """Global entry point: ``shard_map_compat`` of Ulysses over ``mesh``
    (layout and axes as ``ring_attention_sharded``)."""
    spec = _spec(batch_axes, head_axis, seq_axis)

    def local(q, k, v, *, groups):
        return ulysses_attention(q, k, v, group=groups[seq_axis], causal=causal,
                                 sm_scale=sm_scale, impl=impl)

    return shard_map_compat(local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)
