"""Collectives inside a differentiated step, as ``autograd.Function``s over
a ``torch.distributed`` process group.

XLA transposes the JAX package's collectives for the backward; torch needs
each pair written out:

* ``RingShift``: one step of a ring (``lax.ppermute``); its backward moves
  each gradient the other way. Ring attention rotates K/V one rank back,
  the GPipe schedule moves activations one stage on.
* ``SumOver``: all-reduce forward, identity backward (``psum`` of per-rank
  parts that every rank then uses whole).
* ``GradSumOver``: identity forward, all-reduce backward (its counterpart:
  a value every rank holds whole, entering per-rank parts).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shift(tensors, group, to: int, frm: int):
    """Send each tensor to group rank ``to`` and receive its counterpart from
    group rank ``frm``, as one batch of point-to-point ops."""
    to, frm = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    sends = [t.contiguous() for t in tensors]
    if to == frm == dist.get_rank():
        # a ring of one: the shift is a copy (gloo cannot send to itself,
        # so every backend copies and the CPU tests cover the card's path)
        return [t.clone() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, frm, group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


class RingShift(torch.autograd.Function):
    """``RingShift.apply(group, step, *tensors)``: each rank's tensors move
    ``step`` ranks along the ring (rank r's reach rank ``(r + step) % n``;
    the last wraps to the first); the backward moves each gradient back.
    Returns a tuple, one tensor per input."""

    @staticmethod
    def forward(ctx, group, step, *tensors):
        ctx.group, ctx.step = group, step
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return tuple(shift(tensors, group, to=(r + step) % n, frm=(r - step) % n))

    @staticmethod
    def backward(ctx, *grads):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        step = ctx.step
        return (None, None, *shift(grads, ctx.group, to=(r - step) % n, frm=(r + step) % n))


class SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, identity backward: each rank
    holds a part of a sum every rank then uses whole, so each part's
    gradient is the whole sum's."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GradSumOver(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward: the
    entry of a value every rank holds whole into per-rank parts (the
    counterpart of ``SumOver``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None
