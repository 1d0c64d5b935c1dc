"""Flash attention for Hopper (port of ``ray_tpu.ops.attention``).

The JAX package's three Pallas kernels become hand-written CUDA C++ for
``sm_90a`` (sources in ``ops/csrc/``, built at first use by ``ops/_build``):

============================  ===========================================
kernel (wrapper here)         replaces (``ray_tpu/ops/attention.py``)
============================  ===========================================
``flash_fwd``                 ``_fwd_kernel`` via ``_flash_fwd``
``flash_bwd_dq``              ``_bwd_dq_kernel`` via ``_flash_bwd``
``flash_bwd_dkv``             ``_bwd_dkv_kernel`` via ``_flash_bwd``
============================  ===========================================

Each wrapper has two kernels, picked by dtype (``kernel_route``): bf16 runs
on the tensor cores (``flash_fwd_tc.cu``, ``flash_bwd_dq_tc.cu``,
``flash_bwd_dkv_tc.cu``), f32 on the CUDA cores (``flash_fwd.cu``,
``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``); each wrapper's
``route_launches`` counts the launches of each.

Each wrapper launches its kernel for a CUDA tensor and counts the launch in
its ``launches`` attribute; for a CPU tensor it runs the kernel's plain
PyTorch version (``_*_plain``, same function, same casts), which the CPU
tests use and ``chip_smoke.py`` compares the kernel against. There is no
fallback from a CUDA tensor to the plain version. The gradient is wired
through ``FlashAttentionFunction`` (the ``jax.custom_vjp`` of the JAX op).

Layouts as in the JAX op: ``[batch, heads, seq, head_dim]``; GQA keeps K/V
at ``kv_heads`` with ``heads % kv_heads == 0`` and maps each q head to its
kv head inside the kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30
#: head dims the CUDA kernels are instantiated for (16 is the tiny config's)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# block validation, copied from the JAX op so that the port accepts exactly
# the shapes it accepts. The tables are sized for TPU VMEM and do not bind
# the CUDA tiles (64 x 64, ragged edges masked).


def default_blocks(seq_q: int) -> tuple:
    """Forward (block_q, block_k) of the JAX op (v5e-tuned)."""
    return (512, 1024)


BWD_BLOCK_BUCKETS = (
    (1024, (256, 512)),
    (2048, (256, 1024)),
    (4096, (256, 1024)),
)
_BWD_BLOCKS_LONG = (128, 1024)


def default_bwd_blocks(seq_q: int) -> tuple:
    """Backward (block_q, block_k) of the JAX op for this sequence bucket."""
    for bound, blocks in BWD_BLOCK_BUCKETS:
        if seq_q <= bound:
            return blocks
    return _BWD_BLOCKS_LONG


def _pick_block(seq: int, want: int) -> Optional[int]:
    """Largest block <= ``want`` that divides ``seq`` (every candidate
    >= 128); shorter sequences are one block, longer ones with no >= 128
    divisor give None and the caller raises."""
    if seq < 128:
        return seq
    for b in range(min(want, seq), 127, -1):
        if seq % b == 0:
            return b
    if seq <= 1024:
        return seq
    return None


# ---------------------------------------------------------------------------
# reference


def reference_attention(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain attention (O(S^2) memory), as the JAX op's oracle. The causal
    mask is bottom-right aligned (``tril(k=klen-qlen)``), as in JAX."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.ones(qlen, klen, dtype=torch.bool, device=s.device).tril(klen - qlen)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# plain versions of the three kernels ([b*h, s, d] flattened, f32 math with
# the kernels' casts: p and dS are rounded to the storage dtype before their
# second product, exactly where the Pallas kernels round them)


def _expand_kv(x: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    """[b*hk, s, d] -> [b*h, s, d], q head i reading kv head i // (h/hk)."""
    if h == hk:
        return x
    bhk, s, d = x.shape
    b = bhk // hk
    return x.reshape(b, hk, 1, s, d).expand(b, hk, h // hk, s, d).reshape(b * h, s, d)


def _group_sum(x: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    """[b*h, s, d] -> [b*hk, s, d], summing each kv head's q-head group."""
    if h == hk:
        return x
    bh, s, d = x.shape
    return x.reshape(bh // h, hk, h // hk, s, d).sum(2).reshape(bh // h * hk, s, d)


def _scores(q, k, causal, sm_scale):
    """q.K^T * scale in f32, masked entries at -1e30 (so exp gives 0)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:  # top-left aligned (q_pos >= k_pos), as the Pallas mask
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def _fwd_plain(q, k, v, causal, sm_scale, h, hk):
    kx, vx = _expand_kv(k, h, hk), _expand_kv(v, h, hk)
    s = _scores(q, kx, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vx.float()) / l
    return o.to(q.dtype), m + torch.log(l)


def _dS_plain(q, kx, vx, do, lse, delta, causal, sm_scale):
    p = torch.exp(_scores(q, kx, causal, sm_scale) - lse)
    dp = torch.matmul(do.float(), vx.float().transpose(-1, -2))
    return p, p * (dp - delta) * sm_scale


def _bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale, h, hk):
    kx, vx = _expand_kv(k, h, hk), _expand_kv(v, h, hk)
    _, ds = _dS_plain(q, kx, vx, do, lse, delta, causal, sm_scale)
    return torch.matmul(ds.to(k.dtype).float(), kx.float()).to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale, h, hk):
    kx, vx = _expand_kv(k, h, hk), _expand_kv(v, h, hk)
    p, ds = _dS_plain(q, kx, vx, do, lse, delta, causal, sm_scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return _group_sum(dk, h, hk).to(k.dtype), _group_sum(dv, h, hk).to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_kernel_inputs(name: str, tensors, d: int) -> int:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype {dtype} unsupported (float32, bfloat16)")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} unsupported {KERNEL_HEAD_DIMS}")
    return _KERNEL_DTYPES[dtype]


def _check_shapes(q, k, v, h, hk):
    bh, sq, d = q.shape
    if h <= 0 or hk <= 0 or h % hk or bh % h:
        raise ValueError(f"bad head counts h={h} hk={hk} for {bh} q rows")
    if k.shape != (bh // h * hk, k.shape[1], d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)} with h={h}, hk={hk}")
    if min(sq, k.shape[1]) <= 0 or bh > 65535:
        raise ValueError(f"unsupported sizes: bh={bh} sq={sq} sk={k.shape[1]}")


def _launch(fn_name: str, tensors, *scalars) -> None:
    """Call a kernel's C entry point with the tensors' pointers, the scalars
    and the current stream of their device; raise on the launch's error."""
    from ray_tpu_torch.ops import _build

    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_build.library(), fn_name)(*(t.data_ptr() for t in tensors), *scalars,
                                                 stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def _check_rows(lse, delta, q):
    want = (q.shape[0], q.shape[1], 1)
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != want or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {want} on {q.device}")


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel a dtype takes, one rule for all three wrappers (each C
    entry point, ``rtt_flash_{fwd,bwd_dq,bwd_dkv}``, picks by it): bf16 runs
    on the tensor cores (``*_tc.cu``), f32 on the CUDA cores, since a
    tensor-core f32 product is TF32."""
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"dtype {dtype} unsupported (float32, bfloat16)")


fwd_route = kernel_route


def _route(name: str, tensors, d: int) -> tuple:
    """Check a wrapper's inputs; return its dtype code and route. The
    tensor-core kernels copy 16-byte chunks, so their inputs must start on
    a 16-byte boundary."""
    dtype = _check_kernel_inputs(name, tensors, d)
    route = kernel_route(tensors[0].dtype)
    if route == "tensor_core" and any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{name}: bf16 inputs must start on a 16-byte boundary")
    return dtype, route


def _count(fn, route: str) -> None:
    fn.launches += 1
    fn.route_launches[route] += 1


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float, h: int, hk: int):
    """Forward kernel: q ``[b*h, sq, d]``, k/v ``[b*hk, sk, d]`` →
    ``(o [b*h, sq, d] in q's dtype, lse [b*h, sq, 1] f32)``."""
    _check_shapes(q, k, v, h, hk)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, sm_scale, h, hk)
    bh, sq, d = q.shape
    dtype, route = _route("flash_fwd", (q, k, v), d)
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, 1, dtype=torch.float32, device=q.device)
    _launch("rtt_flash_fwd", (q, k, v, o, lse),
            bh, h, hk, sq, k.shape[1], d, float(sm_scale), int(causal), dtype)
    _count(flash_fwd, route)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float, h: int, hk: int):
    """dq kernel: returns dq ``[b*h, sq, d]`` in q's dtype."""
    _check_shapes(q, k, v, h, hk)
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale, h, hk)
    bh, sq, d = q.shape
    dtype, route = _route("flash_bwd_dq", (q, k, v, do), d)
    _check_rows(lse, delta, q)
    dq = torch.empty_like(q)
    _launch("rtt_flash_bwd_dq", (q, k, v, do, lse, delta, dq),
            bh, h, hk, sq, k.shape[1], d, float(sm_scale), int(causal), dtype)
    _count(flash_bwd_dq, route)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float, h: int, hk: int):
    """dk/dv kernel: returns ``(dk, dv)`` ``[b*hk, sk, d]`` in k's/v's dtype,
    each kv head's gradient summed over its GQA group."""
    _check_shapes(q, k, v, h, hk)
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale, h, hk)
    bh, sq, d = q.shape
    dtype, route = _route("flash_bwd_dkv", (q, k, v, do), d)
    _check_rows(lse, delta, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("rtt_flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
            k.shape[0], h, hk, sq, k.shape[1], d, float(sm_scale), int(causal), dtype)
    _count(flash_bwd_dkv, route)
    return dk, dv


KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` and ``route_launches`` to 0."""
    for fn in KERNELS:
        fn.launches = 0
        fn.route_launches = {"tensor_core": 0, "cuda_core": 0}


reset_launch_counts()


# ---------------------------------------------------------------------------
# public op


class FlashAttentionFunction(torch.autograd.Function):
    """The JAX op's ``_flash3`` custom_vjp: the forward kernel saves
    ``(q, k, v, o, lse)``; the backward computes ``delta = rowsum(dO o O)``
    as a plain op and runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, h: int, hk: int):
        o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale, h=h, hk=hk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, sm_scale=sm_scale, h=h, hk=hk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    block_q_bwd: Optional[int] = None,
    block_k_bwd: Optional[int] = None,
    impl: str = "auto",
):
    """Multi-head attention. q: ``[batch, heads, seq, head_dim]``; k/v:
    ``[batch, kv_heads, seq, head_dim]`` with ``heads % kv_heads == 0`` —
    GQA is mapped inside the kernels, repeated K/V is never stored.

    ``impl``: ``"pallas"`` runs the hand-written CUDA kernels (and raises
    on a CPU tensor); ``"xla"`` runs the plain reference (K/V repeated);
    ``"auto"`` takes the kernels for a CUDA tensor and, for a CPU tensor,
    the same autograd function over the kernels' plain versions.

    The ``block_*`` arguments are validated exactly as the JAX op validates
    them (``_pick_block``), so the port accepts the same shapes; the CUDA
    kernels then use their own 64 x 64 tiles and ignore them.

    Causal attention with ``seq_q != seq_k`` raises: the JAX op's kernel
    masks it top-left aligned and its reference bottom-right aligned, so
    the reference has no single answer there.
    """
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla'; got {impl!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, seq_q, d = q.shape
    hk = k.shape[1]
    seq_k = k.shape[2]
    if h % hk:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hk})")
    if causal and seq_q != seq_k:
        raise ValueError(
            f"causal attention needs seq_q == seq_k (got {seq_q}, {seq_k}): the "
            "kernel's top-left and the reference's bottom-right masks disagree"
        )
    if impl == "xla":
        if hk != h:
            k = k.repeat_interleave(h // hk, dim=1)
            v = v.repeat_interleave(h // hk, dim=1)
        return reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "pallas" and q.device.type != "cuda":
        raise ValueError(f"impl='pallas' runs the CUDA kernels; q is on {q.device}")

    dbq, dbk = default_blocks(seq_q)
    bbq, bbk = default_bwd_blocks(seq_q)
    picked = (
        _pick_block(seq_q, block_q or dbq),
        _pick_block(seq_k, block_k or dbk),
        _pick_block(seq_q, block_q_bwd or bbq),
        _pick_block(seq_k, block_k_bwd or bbk),
    )
    if None in picked:
        raise ValueError(
            f"sequence lengths ({seq_q}, {seq_k}) have no block divisor "
            f"≥128 — pad the sequence to a multiple of 128"
        )
    qf = q.reshape(b * h, seq_q, d).contiguous()
    kf = k.reshape(b * hk, seq_k, d).contiguous()
    vf = v.reshape(b * hk, seq_k, d).contiguous()
    o = FlashAttentionFunction.apply(qf, kf, vf, causal, float(sm_scale), h, hk)
    return o.reshape(b, h, seq_q, d)
