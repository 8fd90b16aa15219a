"""The collectives of the port's layout (no JAX counterpart: under GSPMD
XLA inserts them).

Everything here is built from ``all_reduce`` and ``broadcast`` alone,
the two collectives that gloo runs on CUDA tensors, so one code path
serves NCCL on the card, gloo on the CPU and gloo ranks that share a
card.  A gather is an ``all_reduce`` into a zero buffer in which each
rank fills its own slot (``x + 0`` is exact, so the gathered values are
the ranks' own bit for bit).

``active_mesh(mesh)`` makes a layout current for a step's forward on
the calling thread: the train-mode ``BatchNorm`` then takes its
statistics over the data group, the losses reduce the sharded classifier
over the model group and take their batch statistics (MadaCos' median
and means, DELG's EMA target) over the data group, and the operations
that couple a batch's samples (SPECTRUM's batch attention, the
contrastive terms of IRIS and AdaptiveHybrid, SPARSE's distillation)
see the global batch through ``data_gather_grad``.  Outside it, or with
``None``, every function here is the identity.  The layout is read in
the forward only; the backward functions keep the groups they were
given there.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

__all__ = [
    "active_mesh",
    "all_reduce_",
    "average_gradients",
    "copy_to_group",
    "data_axis",
    "data_gather",
    "data_gather_grad",
    "data_mean",
    "data_rows",
    "gather_columns",
    "model_shard",
    "reduce_from_group",
]

_ACTIVE = threading.local()  # .mesh: the calling thread's layout
_BUCKET = 1 << 24  # elements per gradient all_reduce


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` (a ``parallel.mesh.Mesh`` or None) the layout of the
    forward passes this thread runs inside the block."""
    saved, _ACTIVE.mesh = _current(), mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = saved


def _current():
    return getattr(_ACTIVE, "mesh", None)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (no-op for None); returns ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def data_axis():
    """``(group, size, index)`` of the active layout's data axis, or None
    outside a layout."""
    mesh = _current()
    if mesh is None:
        return None
    return mesh.group("data"), mesh.shape["data"], mesh.coords["data"]


def data_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` (a per-rank mean over equal shards) over the
    data ranks: their sum over their count, so one rank gets its own
    value back exactly.  No gradient flows through the reduction."""
    axis = data_axis()
    if axis is None:
        return t
    group, size, _ = axis
    return all_reduce_(t.detach().clone(), group) / size


def data_gather(t: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``t`` (equal shapes) concatenated on dim 0 in
    data order, on every rank; no gradient."""
    axis = data_axis()
    if axis is None:
        return t
    group, size, index = axis
    n = t.shape[0]
    out = t.new_zeros((size * n, *t.shape[1:]))
    out[index * n:(index + 1) * n] = t.detach()
    return all_reduce_(out, group)


class _GatherRows(torch.autograd.Function):
    """Forward: the data ranks' rows concatenated in data order.
    Backward: this rank's rows of the gradient summed over the ranks
    (each rank's loss may read every row)."""

    @staticmethod
    def forward(ctx, t, group, size, index):
        n = t.shape[0]
        ctx.group, ctx.rows = group, slice(index * n, (index + 1) * n)
        out = t.new_zeros((size * n, *t.shape[1:]))
        out[ctx.rows] = t
        return all_reduce_(out, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group)[ctx.rows], None, None, None


def data_gather_grad(t: torch.Tensor) -> torch.Tensor:
    """The data ranks' ``t`` (equal shapes) concatenated on dim 0 in data
    order, on every rank, with a gradient: a batch-wide operation of the
    step computed on it sees the global batch, as JAX's GSPMD step does.
    The gradient of every rank's loss reaches the rows it came from, and
    the step's gradient average divides by the rank count once, so a term
    that every rank computes whole from the gathered rows is counted once
    and a rank's own term (its rows of a gathered computation) once per
    rank, as a mean over equal shards is."""
    axis = data_axis()
    # outside a layout the same node, over a group of one: the gradients
    # of the rows' readers meet in the same order, so a layout of one
    # steps bit for bit as the plain step
    return _GatherRows.apply(t, *(axis or (None, 1, 0)))


def data_rows(whole: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` rows of a tensor over the global batch (the
    layout of ``data_gather_grad``); ``whole`` outside a layout."""
    axis = data_axis()
    if axis is None:
        return whole
    index = axis[2]
    return whole[index * n:(index + 1) * n]


def gather_columns(t: torch.Tensor, cols: slice, full: int,
                   group) -> torch.Tensor:
    """The whole ``[..., full]`` tensor of which this rank holds columns
    ``cols``, from every rank of ``group``; no gradient."""
    out = t.new_zeros((*t.shape[:-1], full))
    out[..., cols] = t.detach()
    return all_reduce_(out, group)


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the identity, because
    every rank of the group computes the same downstream function of
    the sum (Megatron's row-parallel reduction)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity on a tensor every rank of the group holds
    whole.  Backward: the sum of the ranks' gradients, each of which
    covers only the part that rank used."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(t, group)


def model_shard(features_dim: int, weight: torch.Tensor):
    """``(group, cols)`` when ``weight`` ([num_classes, d]) is this rank's
    column shard of a classifier over ``features_dim`` features under
    the active layout; None when it is whole.  A weight narrower than
    the features without a model axis that explains it raises."""
    d = weight.shape[-1]
    if d == features_dim:
        return None
    mesh = _current()
    n = 1 if mesh is None else mesh.shape["model"]
    if mesh is None or d * n != features_dim:
        raise ValueError(
            f"classifier weight of width {d} for {features_dim} features: "
            f"a column shard needs the layout that made it (active layout "
            f"{None if mesh is None else mesh.shape})")
    j = mesh.coords["model"]
    return mesh.group("model"), slice(j * d, (j + 1) * d)


def average_gradients(params, group, size: int) -> None:
    """Average ``p.grad`` over ``group`` in place, in buckets of at most
    16M elements per dtype (one ``all_reduce`` each); a missing gradient
    counts as zeros."""
    if group is None:
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault((g.dtype, g.device), []).append(g)
    for same in by_dtype.values():
        bucket, count = [], 0
        for g in same + [None]:
            if g is not None and (not bucket
                                  or count + g.numel() <= _BUCKET):
                bucket.append(g)
                count += g.numel()
                continue
            if bucket:
                flat = torch.cat([b.reshape(-1) for b in bucket])
                all_reduce_(flat, group)
                flat /= size
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
            if g is not None:
                bucket, count = [g], g.numel()
