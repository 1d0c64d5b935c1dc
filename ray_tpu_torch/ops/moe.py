"""Mixture-of-Experts FFN with expert parallelism (port of ``ray_tpu.ops.moe``).

The dense-dispatch recipe (Switch/GShard): top-k routing produces a
capacity-limited one-hot dispatch tensor; dispatch and combine are einsums,
and the expert FFNs run batched over the expert dim. The JAX package shards
the expert dim over the ``expert`` mesh axis and lets XLA insert the
collectives; the port's ``moe_ffn_sharded`` routes every token on every
rank (the global routing of the JAX function, whatever the batch
sharding), runs the rank's own experts and sums their outputs over the
``expert`` axis.

Capacity semantics: each expert processes at most
``capacity = ceil(top_k * tokens / experts * capacity_factor)`` token
choices; overflow choices pass through unchanged (their combine weight is
zero), the Switch Transformer drop policy. These are einsums and
elementwise ops, as in the JAX package (no Pallas kernel there), so they
stay torch ops here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.mesh import EXPERT, mesh_axis_sizes, shard_map_compat
from ray_tpu_torch.parallel.sharding import PartitionSpec as P

#: the parameter names of one MoE FFN, in ``init_moe_params``' draw order
MOE_PARAMS = ("router", "w_gate", "w_up", "w_down")


def init_moe_params(
    generator: torch.Generator,
    dim: int,
    hidden: int,
    num_experts: int,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Router + per-expert SwiGLU FFN params (stacked over experts), drawn
    from ``generator`` on its device. The router stays f32."""

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device) * scale

    scale_in, scale_hid = 1.0 / math.sqrt(dim), 1.0 / math.sqrt(hidden)
    return {
        "router": normal((dim, num_experts), scale_in),
        "w_gate": normal((num_experts, dim, hidden), scale_in).to(dtype),
        "w_up": normal((num_experts, dim, hidden), scale_in).to(dtype),
        "w_down": normal((num_experts, hidden, dim), scale_hid).to(dtype),
    }


def moe_logical_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes for the params above (rules map "expert" to the
    ``expert`` mesh axis)."""
    return {
        "router": (None, None),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def moe_capacity(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """GShard capacity: the expected per-expert load is ``top_k * T / E``
    choices under balanced routing."""
    return max(1, int(math.ceil(top_k * tokens / num_experts * capacity_factor)))


def _route(router, xt, *, top_k, capacity, router_noise, generator):
    """Top-k routing of the tokens ``xt [T, d]``: the dispatch and combine
    tensors ``[T, E, C]`` (f32) and the aux dict."""
    T = xt.shape[0]
    E = router.shape[1]
    logits = xt.float() @ router  # [T, E]
    if router_noise > 0.0 and generator is not None:
        logits = logits + router_noise * torch.randn(
            logits.shape, generator=generator, dtype=torch.float32, device=logits.device)
    probs = torch.softmax(logits, dim=-1)

    # top-k expert choices per token, the kept gates renormalised
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # per-(token, choice) slot within the chosen expert, by arrival order:
    # cumsum of the one-hot over the flattened (T*k) axis
    choice_onehot = F.one_hot(expert_idx, E)  # [T, k, E] int64
    flat_choice = choice_onehot.reshape(T * top_k, E)
    positions = flat_choice.cumsum(0) - flat_choice  # slots before me
    slot = (positions * flat_choice).sum(-1).reshape(T, top_k)  # [T, k]
    kept = slot < capacity
    gate_vals = gate_vals * kept.to(gate_vals.dtype)

    # jax.nn.one_hot gives zeros for an overflow slot; F.one_hot raises on
    # it, so the overflow rows are masked instead
    slot_onehot = F.one_hot(torch.where(kept, slot, 0), capacity).float()
    slot_onehot = slot_onehot * kept[..., None].float()  # [T, k, C]
    choice_f = choice_onehot.float()
    disp = torch.einsum("tke,tkc->tec", choice_f, slot_onehot)
    combine = torch.einsum("tk,tke,tkc->tec", gate_vals, choice_f, slot_onehot)

    # Switch load-balance aux loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)  # mean router prob per expert
    ce = choice_f[:, 0, :].mean(dim=0)  # top-1 fraction
    aux = {"aux_loss": E * torch.sum(me * ce),
           "dropped_fraction": 1.0 - kept.float().mean()}
    return disp, combine, aux


def _experts(disp, combine, xt, w_gate, w_up, w_down, dtype):
    """Route the tokens into expert slots, run the SwiGLU FFNs batched over
    the experts of ``w_*`` and combine back: ``[T, d]`` in f32."""
    expert_in = torch.einsum("tec,td->ecd", disp, xt.float()).to(dtype)  # [E, C, d]
    h_gate = torch.einsum("ecd,edh->ech", expert_in, w_gate)
    h_up = torch.einsum("ecd,edh->ech", expert_in, w_up)
    expert_out = torch.einsum("ech,ehd->ecd", F.silu(h_gate) * h_up, w_down)
    return torch.einsum("tec,ecd->td", combine, expert_out.float())


def moe_ffn(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    router_noise: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: ``[B, S, d]`` → ``(out [B, S, d], {"aux_loss", "dropped_fraction"})``.

    Dense dispatch: one-hot ``[T, E, C]`` tensors route tokens to expert
    slots; dropped (over-capacity) choices contribute zero and fall back to
    the residual stream. ``router_noise`` adds Gaussian noise to the router
    logits, drawn from ``generator`` (no noise without one)."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    T = B * S
    capacity = moe_capacity(T, E, top_k, capacity_factor)
    xt = x.reshape(T, d)
    disp, combine, aux = _route(params["router"], xt, top_k=top_k, capacity=capacity,
                                router_noise=router_noise, generator=generator)
    out = _experts(disp, combine, xt, params["w_gate"], params["w_up"], params["w_down"],
                   x.dtype)
    return out.reshape(B, S, d).to(x.dtype), aux


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, identity backward: each rank
    holds a part of a sum every rank then uses whole, so each part's
    gradient is the whole sum's."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradSumOver(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward: the
    entry of a value every rank holds whole into per-rank parts (the
    counterpart of ``_SumOver``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _moe_local(x, router, w_gate, w_up, w_down, *, groups, top_k, capacity_factor):
    """One rank's part of ``moe_ffn``: every token routed (``x`` is the whole
    batch on every rank), this rank's experts run, and their outputs summed
    over the expert axis."""
    import torch.distributed as dist

    group = groups[EXPERT]
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, S, d = x.shape
    E = router.shape[1]
    e_loc = w_gate.shape[0]
    T = B * S
    xt = x.reshape(T, d)
    disp, combine, aux = _route(router, xt, top_k=top_k,
                                capacity=moe_capacity(T, E, top_k, capacity_factor),
                                router_noise=0.0, generator=None)
    mine = slice(r * e_loc, (r + 1) * e_loc)
    if n > 1:
        xt, combine = _GradSumOver.apply(xt, group), _GradSumOver.apply(combine, group)
    out = _experts(disp[:, mine], combine[:, mine], xt, w_gate, w_up, w_down, x.dtype)
    if n > 1:
        out = _SumOver.apply(out, group)
    return out.reshape(B, S, d).to(x.dtype), aux["aux_loss"], aux["dropped_fraction"]


def moe_ffn_sharded(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_ffn`` (without router noise) with the experts split over
    ``mesh``'s ``expert`` axis (``shard_map_compat``): the tokens are
    gathered and routed whole on every rank, so capacity and slot order are
    the global ones the JAX function computes on global arrays; each rank
    runs its own experts and the outputs are summed over the expert axis.
    DTensor inputs give replicated DTensor outputs; plain inputs (the full
    values on every rank), plain outputs."""
    import functools

    E = params["router"].shape[1]
    n = mesh_axis_sizes(mesh)[EXPERT]
    if E % n:
        raise ValueError(f"{E} experts do not split evenly over {n} {EXPERT!r} ranks")
    fn = shard_map_compat(
        functools.partial(_moe_local, top_k=top_k, capacity_factor=capacity_factor),
        mesh=mesh,
        in_specs=(P(), P(), P(EXPERT), P(EXPERT), P(EXPERT)),
        out_specs=(P(), P(), P()),
    )
    out, aux_loss, dropped = fn(x, *(params[k] for k in MOE_PARAMS))
    return out, {"aux_loss": aux_loss, "dropped_fraction": dropped}
