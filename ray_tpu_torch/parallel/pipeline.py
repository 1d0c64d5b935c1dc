"""Pipeline parallelism: GPipe scheduling over the ``stage`` mesh axis
(port of ``ray_tpu.parallel.pipeline``).

One program on every rank of the ``stage`` axis (``shard_map_compat``):
each rank holds its stage's slice of the stacked params, and microbatch
activations hop stage→stage by a ring shift (``comm.RingShift``, the
counterpart of ``lax.ppermute``) once per step of a Python loop.

Schedule: microbatch m is computed by stage s at step t = m + s; the
pipeline runs M + S - 1 steps (fill + drain). Stage 0 injects from the
input queue; the last stage's results are collected per step and
broadcast at the end (``comm.SumOver``: an all-reduce of what only the
last stage holds, whose backward is the identity, as ``psum``'s transpose
is).

The backward's point-to-point shifts must meet on neighbouring ranks in
the same order, as the transposed ``ppermute``s of the JAX program do. So,
as in that program, every rank computes every step (fill and drain
included) and keeps every shift in its graph: stage 0 ties the state it
drops to what it injects, and every rank ties its last state to its
output (``_Tie``, a zero gradient). A stage axis of one runs the same
path: each shift sends to the rank itself and the sum is over one rank."""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ray_tpu_torch.parallel.comm import RingShift, SumOver
from ray_tpu_torch.parallel.mesh import STAGE, mesh_axis_sizes, shard_map_compat
from ray_tpu_torch.parallel.sharding import PartitionSpec as P


def stack_stage_params(per_stage_params: list):
    """[params_stage0, params_stage1, ...] → one tree with a leading
    ``num_stages`` dim (the shard_map input over the stage axis)."""
    leaves, spec = zip(*(pytree.tree_flatten(p) for p in per_stage_params))
    return pytree.tree_unflatten([torch.stack(xs, dim=0) for xs in zip(*leaves)], spec[0])


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``other`` joined to its graph at zero gradient:
    the backward then reaches the shifts that made ``other``."""

    @staticmethod
    def forward(ctx, x, other):
        ctx.like = (other.shape, other.dtype, other.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def pipeline_apply(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    microbatches: torch.Tensor,
    *,
    stage_axis: str = STAGE,
):
    """Run ``microbatches [M, ...]`` through ``num_stages`` pipeline
    stages. ``stage_fn(stage_params, x) -> x`` is one stage's compute;
    ``stacked_params`` carries a leading ``num_stages`` dim (see
    ``stack_stage_params``). Returns outputs ``[M, ...]`` on every rank.

    Differentiable: gradients reach each stage's params (every rank's
    ``.grad`` holds the whole stacked gradient, as ``jax.grad`` returns it)."""
    num_stages = mesh_axis_sizes(mesh)[stage_axis]
    M = microbatches.shape[0]
    leaves, spec = pytree.tree_flatten(stacked_params)

    def inner(*args, groups):
        *local, xs = args  # local leaves: [1, ...] (this stage's slice)
        p = pytree.tree_unflatten([a[0] for a in local], spec)
        group = groups[stage_axis]
        s = dist.get_rank(group)
        state = torch.zeros_like(xs[0])
        outputs = []
        for t in range(M + num_stages - 1):
            if s == 0:
                # stage 0 injects microbatch t (clamped: the drain's
                # injections reach no output)
                inject = xs[min(t, M - 1)]
                state = _Tie.apply(inject, state) if t > 0 else inject
            state = stage_fn(p, state)
            # the last stage emits microbatch t-(S-1) after its compute
            if s == num_stages - 1 and t >= num_stages - 1:
                outputs.append(state)
            (state,) = RingShift.apply(group, 1, state)
        # results live on the last stage only: broadcast to every stage
        out = torch.stack(outputs) if outputs else torch.zeros_like(xs)
        return SumOver.apply(_Tie.apply(out, state), group)

    fn = shard_map_compat(
        inner,
        mesh=mesh,
        in_specs=(P(stage_axis),) * len(leaves) + (P(),),
        out_specs=P(),
    )
    return fn(*leaves, microbatches)
