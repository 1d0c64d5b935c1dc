"""Compute kernels (hand-written CUDA C++ for Hopper) + reference versions.

Port of ``ray_tpu.ops``: flash attention (the kernels), the model layers,
sequence-parallel attention (ring and Ulysses) and the MoE FFN."""

from ray_tpu_torch.ops.attention import flash_attention, reference_attention
from ray_tpu_torch.ops.layers import apply_rope, rms_norm, rope_frequencies
from ray_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_sharded,
    ulysses_attention,
    ulysses_attention_sharded,
)

__all__ = [
    "flash_attention",
    "reference_attention",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
]
