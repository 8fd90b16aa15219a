"""Parameter freezing as masks over the optimizer's parameters
(port of ``research_image_retrieval_tpu/train/freeze.py``).

The JAX package freezes through ``optax.multi_transform`` with
``set_to_zero`` on the masked-out leaves; here a mask over the model's
``named_parameters()`` is bound into the ``Transform``
(``apply_freeze``), and the ``Optimizer`` it builds leaves the frozen
parameters out of everything it does: no update, no weight decay, no
momentum or Adam state, no share in the clipping norm or the
accumulation.  The ``grad_norm`` the step reports still covers every
gradient, as the JAX step's does.

A parameter matches a name when any dot-separated component of its
name equals it (``"backbone"`` freezes ``backbone.layer1.0.conv1.weight``).
Component names follow the port's modules, which keep flax's names but
for the backbone's torchvision layout (flax ``layer1_0`` is ``layer1`` /
``0`` here, ``downsample_bn`` is ``downsample`` / ``1``) and the leaves
(flax ``kernel`` / ``scale`` are ``weight``).
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, Sequence

import torch.nn as nn

from research_image_retrieval_tpu_torch.train.optimizer import Transform

__all__ = ["apply_freeze", "freeze_all_but", "freeze_mask"]


def _named(model) -> Iterable[tuple[str, object]]:
    return (model.named_parameters() if isinstance(model, nn.Module)
            else model)


def freeze_mask(model, frozen_submodules: Sequence[str]) -> dict:
    """``{name: trainable}`` over ``model.named_parameters()`` (or an
    iterable of ``(name, parameter)``): False under any named submodule."""
    frozen = set(frozen_submodules)
    return {n: not (set(n.split(".")) & frozen) for n, _ in _named(model)}


def freeze_all_but(model, keep_patterns: Sequence[str]) -> dict:
    """Trainable only where a name component is in ``keep_patterns``
    (``["bn1", "bn2", "bn3"]``: every BN but the projections')."""
    keep = set(keep_patterns)
    return {n: bool(set(n.split(".")) & keep) for n, _ in _named(model)}


def apply_freeze(tx: Transform, mask_fn: Callable[[nn.Module], dict]
                 ) -> Transform:
    """A copy of ``tx`` whose optimizer updates only the parameters that
    ``mask_fn(model)`` marks True; the others get a zero update."""
    out = copy.copy(tx)
    out.mask_fn = mask_fn
    return out
