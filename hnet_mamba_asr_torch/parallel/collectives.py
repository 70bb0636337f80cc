"""The collectives of the port's multi-rank planes, over ``torch.distributed``.

The plain ``torch.distributed`` calls have no backward. Every collective that
a gradient passes through here is an ``autograd.Function`` of this module
with its adjoint:

- ``all_reduce_sum``: y = sum over the group of x; the backward sums the
  incoming gradients over the group as well (each rank computes the same
  function of y, so the adjoint of "every rank reads y" is that sum);
- ``all_gather``: y [W, ...] = every rank's x stacked in rank order; the
  backward sums the gradients of y over the group and keeps this rank's row.

The model-axis collectives of tp and ep (Megatron's), for ranks that hold
the same rows and compute the same loss, so that a replicated tensor's
gradient is already whole on every rank:

- ``copy_to_model``: identity; the backward sums the gradients over the
  group (the input of a column-split GEMM, or of a rank's own experts);
- ``reduce_from_model``: y = sum over the group; the backward is the
  identity (the partial products of a row-split GEMM, the ranks' experts);
- ``gather_from_model``: every rank's x concatenated along a dim in rank
  order; the backward keeps this rank's slice.

They sum in fp32 whatever the tensor's dtype (a bf16 gradient of a
replicated input is summed once and rounded once).

The pipeline's exchanges over a pp group (``parallel/pipeline.py``): into
the pipeline ``copy_to_model`` (only stage 0 reads its input, the other
stages' gradients of it are zeros, so the sum is stage 0's on every rank),
out of it ``reduce_from_model`` (the last stage's buffer, zeros on the
other stages), and between stages ``stage_shift``: rank r receives rank r -
step's tensor. Its adjoint is the shift by -step, which the pipeline's
written-out backward applies (the shift runs outside autograd, so that
every rank makes it at every tick in the same order).

``all_reduce_sum``'s backward would multiply such a gradient by the group's
size; it stays right where each rank uses the sum for its own channels (the
gated RMSNorm's sum of squares under tp).

Both run on ``all_reduce`` under gloo (the gather as a sum of zero-padded
stacks, exact in floating point: x + 0 = x), which gloo takes on CPU
tensors and on CUDA tensors alike, and on ``all_gather_into_tensor`` under
NCCL. Sums therefore cost one all-reduce and gathers W times the bytes of
one under gloo; the tensors gathered here are states and halos, or one
shard's features.

The batch-wide sums of the losses (``batch_sum``) go over the group that
splits a batch's rows between ranks, set by ``rows_split_over`` around a
training micro-step; outside it (one process, a dev batch every rank holds
whole) ``batch_sum`` is the identity, so one process computes exactly what
it computed before the multi-rank planes existed. With the sums global,
every rank forms the same loss, and the averaging of the data-parallel
wrapper (DDP's all-reduce mean, FSDP's reduce-scatter mean) turns the
per-rank gradients of that loss into the gradient of the one-rank loss on
the global batch, whatever the rows and tokens each rank holds. Random
draws keyed by the step (AED dropout) take the global batch's draw and keep
this rank's rows (``row_slice``), so that two ranks draw what one draws.
The row group is a process-wide setting on purpose: the sums sit deep in
the models (the losses, the ratio loss, the MoE routing), and a context
manager that restores the previous group keeps it scoped to a micro-step.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

_ROWS_GROUP = None            # the process group that splits a batch's rows (None: none)


def group_size(group) -> int:
    """The group's size; 1 without a process group."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def _is_nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _reduce_(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    W, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if _is_nccl(group):
        out = x.new_empty((W,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = x.new_zeros((W,) + tuple(x.shape))
    out[r] = x
    return _reduce_(out, group)


def stage_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Rank r of ``group`` receives rank r - ``step``'s ``x`` (zeros where
    r - step lies outside the group), in x's dtype: a gather in fp32 (exact),
    which gloo takes on CUDA tensors; no gradient. Its adjoint is
    ``stage_shift(g, group, -step)``."""
    src = dist.get_rank(group) - step
    got = _gather(x.detach().float().contiguous(), group)
    if 0 <= src < dist.get_world_size(group):
        return got[src].to(x.dtype)
    return torch.zeros_like(x)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = _reduce_(g.contiguous().clone(), ctx.group)
        return g[dist.get_rank(ctx.group)], None


def _reduce32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group in fp32, cast back to x's dtype."""
    return _reduce_(x.float().contiguous().clone(), group).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _cat_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along dim (gathered in fp32: exact)."""
    return torch.cat(list(_gather(x.float(), group).unbind(0)), dim=dim).to(x.dtype)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return _cat_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` (tp / ep)."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes unchanged."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    return _reduce32(x.detach(), group)


def gather_from_model(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient keeps this rank's slice."""
    if group_size(group) == 1:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromModel.apply(x, group, dim)
    return _cat_gather(x.detach(), group, dim)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (differentiable); the identity on a
    group of one rank."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _reduce_(x.detach().clone(), group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, [W, *x.shape]
    (differentiable)."""
    if group_size(group) == 1:
        return x[None]
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, group)
    return _gather(x.detach(), group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over ``group`` (no gradient): gloo and NCCL both
    take MAX."""
    if group_size(group) == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


@contextmanager
def rows_split_over(group):
    """Within the block, ``batch_sum`` sums over ``group``: the ranks that
    hold disjoint rows of one global batch (None: one process)."""
    global _ROWS_GROUP
    prev = _ROWS_GROUP
    _ROWS_GROUP = group if group is not None and group_size(group) > 1 else None
    try:
        yield
    finally:
        _ROWS_GROUP = prev


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over a batch's rows made global: over the ranks that split the
    rows (``rows_split_over``), else ``x`` itself."""
    if _ROWS_GROUP is None:
        return x
    return all_reduce_sum(x, _ROWS_GROUP)


def rows_group():
    """The group that ``rows_split_over`` set, or None."""
    return _ROWS_GROUP


def row_slice():
    """(this rank's index, the rank count) of the row split that
    ``rows_split_over`` set, or None: a draw keyed by the global row (AED
    dropout) takes the global batch's draw and keeps this rank's rows."""
    if _ROWS_GROUP is None:
        return None
    return dist.get_rank(_ROWS_GROUP), dist.get_world_size(_ROWS_GROUP)
