"""Batch statistics over the global batch of a data-parallel step.

JAX's default multi-device step is one GSPMD program over the global batch,
so every batch statistic in it (BatchNorm's moments, K7's similarity
moments and the sum its backward forms, the Switch-MoE routing groups, the
Dice ratio) is taken over the whole batch (``README.md`` "Parallelism
options"). In the port each rank holds its rows of that batch, so each such
statistic is summed over the ranks of the data group before it is used.

:func:`global_batch_statistics` names the group a step reduces over; the
sites read it with :func:`data_group`. Outside it (a single-process run, the
per-replica step of ``parallel/shard_map_step.py``) every site runs as it
did before this module, bit for bit. :func:`all_reduce_sum` is a sum over
the group that gradients flow through: its backward sums the incoming
gradients over the group in turn, so that each rank's backward carries the
part of every rank's loss that its rows reach through the shared statistic.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_STATE = threading.local()


def data_group() -> Optional[dist.ProcessGroup]:
    """The process group that batch statistics are summed over, or None."""
    return getattr(_STATE, "group", None)


@contextlib.contextmanager
def global_batch_statistics(group: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Within, batch statistics are taken over the rows of every rank of
    ``group`` (None: over this process's rows, as without the context)."""
    saved = data_group()
    _STATE.group = group
    try:
        yield
    finally:
        _STATE.group = saved


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor; ``t`` itself where the group
    is None), differentiable."""
    return t if group is None else _AllReduceSum.apply(t, group)


def global_moments(x: torch.Tensor, dims: Sequence[int], group: Optional[dist.ProcessGroup]
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Mean and biased variance of ``x`` over ``dims`` of every rank's rows,
    and the count they are over: each rank's count, sum and sum of squares
    in float64 (the squares rounded once in the compute type), summed over
    the group, then ``var = E[x^2] - mean^2``. Mean and variance come back in
    the compute type (float32, or float64 for a float64 ``x``) and carry
    gradients; the ranks' row counts must be equal."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    count = 1
    for d in dims:
        count *= x.shape[d]
    sums = torch.stack([xf.sum(dims, dtype=torch.float64),
                        (xf * xf).sum(dims, dtype=torch.float64)])
    sums = all_reduce_sum(sums, group)
    count *= group_size(group)
    mean = sums[0] / count
    var = (sums[1] / count - mean * mean).clamp_min(0.0)
    return mean.to(ct), var.to(ct), count


class _CudaBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the group's global batch from ATen's CUDA
    batch-norm kernels, composed as ``torch.nn.SyncBatchNorm`` composes them
    (it refuses CPU tensors and updates the running variance unbiased, so
    the port composes them itself): each rank's Welford mean and inverse
    deviation (``batch_norm_stats``) gathered over the group and combined
    by count (``batch_norm_gather_stats_with_counts``), then one
    normalising pass (``batch_norm_elemt``); in the backward the two
    per-channel sums (``batch_norm_backward_reduce``) are all-reduced
    before the input gradient is formed (``batch_norm_backward_elemt``).
    The weight and bias gradients are this rank's share, as every
    parameter gradient of the step is before its all-reduce."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        if not (x.is_contiguous(memory_format=torch.channels_last)
                or x.is_contiguous(memory_format=torch.channels_last_3d)):
            x = x.contiguous()
        c, world = x.shape[1], dist.get_world_size(group)
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = mean.new_full((1,), x.numel() // c)
        local = torch.cat([mean, invstd, count])
        gathered = local.new_empty(world * local.numel())
        dist.all_gather_into_tensor(gathered, local, group=group)
        mean_all, invstd_all, count_all = gathered.view(world, -1).split(c, dim=1)
        counts = count_all.reshape(-1)
        # momentum-1 buffers take the global mean and unbiased variance (and
        # make the kernel read the counts in their float type, not x's)
        mean_buf, var_buf = mean.new_zeros(c), mean.new_ones(c)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, mean_all, invstd_all, mean_buf, var_buf, 1.0, eps, counts)
        y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        n = counts.sum()
        var = var_buf * ((n - 1) / n)
        ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        ctx.group, ctx.affine = group, (weight is not None, bias is not None)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        if not (dy.is_contiguous(memory_format=torch.channels_last)
                or dy.is_contiguous(memory_format=torch.channels_last_3d)):
            dy = dy.contiguous()
        need_x = ctx.needs_input_grad[0]
        need_w, need_b = (n and a for n, a in zip(ctx.needs_input_grad[1:3], ctx.affine))
        sum_dy, sum_dy_xmu, d_w, d_b = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, need_x, need_w, need_b)
        d_x = None
        if need_x:
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=ctx.group)
            sum_dy, sum_dy_xmu = sums.split(x.shape[1])
            d_x = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy,
                                                  sum_dy_xmu, counts)
        return d_x, d_w if need_w else None, d_b if need_b else None, None, None


def cuda_batch_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], eps: float, group: dist.ProcessGroup
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of a CUDA ``x`` over the global batch of
    ``group`` (see :class:`_CudaBatchNorm`): the output in ``x``'s type, the
    float32 mean and biased variance (float64 for a float64 ``x``). The
    ranks' row counts may differ."""
    if not x.is_cuda:
        raise ValueError(f"cuda_batch_norm takes a CUDA tensor, not one on {x.device}")
    return _CudaBatchNorm.apply(x, weight, bias, eps, group)
