"""Model-layer ops: RMSNorm, rotary embeddings (port of ``ray_tpu.ops.layers``).

Plain PyTorch: these are elementwise and left to PyTorch's own kernels, as
the JAX package leaves them to XLA's fusion.

This ``apply_rope`` is HALF-SPLIT (rotates ``x[..., :d/2]`` against
``x[..., d/2:]``); the Llama model keeps its own interleaved even/odd
variant in ``ray_tpu_torch.models.llama``.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation (Llama-style); the weight is cast to
    fp32 before the multiply, the result back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0, *,
                     device=None):
    """Precomputed cos/sin tables: ``[max_seq, head_dim//2]`` (fp32)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions=None) -> torch.Tensor:
    """Rotary position embedding. x: ``[batch, heads, seq, head_dim]``;
    cos/sin: ``[max_seq, head_dim//2]``; positions: ``[batch, seq]`` or
    None (implicit arange)."""
    seq = x.shape[2]
    if positions is None:
        c = cos[:seq][None, None, :, :]
        s = sin[:seq][None, None, :, :]
    else:
        c = cos[positions][:, None, :, :]
        s = sin[positions][:, None, :, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
