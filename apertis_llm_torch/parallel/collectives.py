"""The two collectives of the port's parallel training, over CUDA or CPU
tensors: both take CUDA tensors under gloo (which passes them through the
host) as under NCCL.

``all_gather`` is differentiable: the transpose of an all-gather is a
sum-scatter, written as an all-reduce of the stacked cotangents of which
each rank keeps its own slice, so that nothing but ``all_gather`` and
``all_reduce`` is needed (``torch.distributed.nn``'s all-gather takes an
``all_to_all`` backward off NCCL, which gloo does not run on CUDA tensors).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x``, stacked in group-rank order: (ranks, *x.shape).
    Its gradient sums each slot's cotangent over the ranks (one all-reduce),
    so every rank must run the backward: use the whole result in the graph
    on every rank."""
    return _AllGather.apply(x, group)


# The largest bucket of small tensors flattened into one all-reduce: few
# collectives for a model's many small leaves, a bounded extra buffer.
BUCKET_BYTES = 256 << 20


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks of ``group`` (the world by default), in
    place: one all-reduce per bucket of up to ``BUCKET_BYTES`` of tensors of
    one dtype, flattened into one buffer (a larger tensor goes alone)."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        if len(bucket) == 1:
            dist.all_reduce(bucket[0], group=group)
        elif bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
        bucket.clear()

    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("all_reduce_sum: tensors must be contiguous")
        n = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or size + n > BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(t)
        size += n
    flush()
