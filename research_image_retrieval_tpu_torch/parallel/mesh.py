"""Rank layout and sharding rules (port of
``research_image_retrieval_tpu/parallel/mesh.py``).

The JAX mesh is a grid of devices under one controller; here it is a
grid of processes, one per GPU: ``world = data x model`` ranks, rank
``r`` at ``(r // model, r % model)`` (JAX's row-major reshape).

* ``data`` axis: each rank of a row holds its share of the global batch;
  gradients, BN statistics and metrics reduce over the column of ranks
  that share a model index (the ``data`` group).
* ``model`` axis: the ranks of one row see the same batch and split the
  ``[num_classes, D]`` ArcFace weight on its feature dimension (the
  ``model`` group); the partial dot products and row norms reduce over
  that group.

With ``model = 1`` JAX shards the classifier over the data axis instead;
the port keeps it whole on every rank (the same numbers, 0.67 GB more
per rank at 81,313 x 2048 fp32).  The step semantics are JAX's
global-array semantics: a step on any layout equals the single-device
step on the same global batch, up to reduction order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from research_image_retrieval_tpu_torch.parallel.dist_init import (
    get_rank,
    get_world_size,
)

__all__ = [
    "Mesh",
    "classifier_sharding",
    "data_sharding",
    "make_mesh",
    "shard_train_state_rules",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``data x model`` layout of the world's ranks, seen from ``rank``.

    ``shape`` is ``{"data": D, "model": M}``; ``coords`` this rank's
    ``{"data": i, "model": j}``.  ``data_group`` / ``model_group`` are
    the process groups of this rank's column and row; they are None only
    for a layout built without ``torch.distributed`` (a single process,
    or a layout to inspect), and then a collective over an axis longer
    than 1 raises."""

    shape: dict
    rank: int
    data_group: object = None
    model_group: object = None

    @property
    def coords(self) -> dict:
        m = self.shape["model"]
        return {"data": self.rank // m, "model": self.rank % m}

    def group(self, axis: str):
        """The process group of ``axis``, or None when it has one rank
        and no group; raises for a longer axis without one."""
        group = self.data_group if axis == "data" else self.model_group
        if group is None and self.shape[axis] > 1:
            raise RuntimeError(f"mesh {self.shape} has no process group for "
                               f"its {axis} axis (torch.distributed not "
                               "initialized)")
        return group


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The ``data x model`` layout over the world's ranks (default: every
    rank on the data axis, JAX's "all devices").  Raises ``ValueError``
    when ``data * model`` is not the world size.  With
    ``torch.distributed`` initialized every rank must call it, in the
    same order (it makes the axes' process groups, also at world size
    1); without it the layout has no groups (a single process)."""
    n = get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    rank = get_rank()
    data_group = model_group = None
    if dist.is_initialized():
        # every rank creates every group, in one order
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if rank // model == d:
                model_group = g
        for m in range(model):
            g = dist.new_group(list(range(m, n, model)))
            if rank % model == m:
                data_group = g
    return Mesh({"data": data, "model": model}, rank, data_group, model_group)


def data_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` that this rank holds: the
    ``i``-th of ``data`` equal blocks, ``i`` its data coordinate."""
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"global batch {n} does not split over "
                         f"{d} data ranks")
    i = mesh.coords["data"]
    return slice(i * n // d, (i + 1) * n // d)


def classifier_sharding(mesh: Mesh, dim: int) -> slice | None:
    """The feature columns of a ``[num_classes, dim]`` classifier weight
    that this rank holds: its model coordinate's block when the model
    axis is longer than 1 and divides ``dim``; None (the whole weight)
    otherwise."""
    n, j = mesh.shape["model"], mesh.coords["model"]
    if n == 1 or dim % n:
        return None
    return slice(j * dim // n, (j + 1) * dim // n)


def shard_train_state_rules(mesh: Mesh, classifier_key: str = "classifier_w"):
    """``rule(name, tensor) -> slice | None``: the columns of a parameter
    (and of its optimizer slots) that this rank keeps.  The classifier
    weight (a parameter named ``classifier_key``, rank >= 2) is sharded
    on its last dimension; everything else, and a classifier whose
    feature dimension does not divide the axis, stays whole."""

    def rule(name: str, tensor: torch.Tensor) -> slice | None:
        if classifier_key in name.split(".") and tensor.ndim >= 2:
            return classifier_sharding(mesh, tensor.shape[-1])
        return None

    return rule
