"""Compute kernels (hand-written CUDA C++ for Hopper) + reference versions.

Port of ``ray_tpu.ops`` as far as the training slice needs it; ring
attention and Ulysses are not ported yet (ROADMAP Queue A)."""

from ray_tpu_torch.ops.attention import flash_attention, reference_attention
from ray_tpu_torch.ops.layers import apply_rope, rms_norm, rope_frequencies

__all__ = [
    "flash_attention",
    "reference_attention",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
]
