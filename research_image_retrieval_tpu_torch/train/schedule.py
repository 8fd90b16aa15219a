"""Learning-rate schedule (port of
``research_image_retrieval_tpu/train/schedule.py``).

``warmup_cosine_schedule``: linear warmup from ``warmup_lr`` to
``base_lr`` over ``warmup_epochs`` (endpoint included), then cosine decay
``final + 0.5 * (base - final) * (1 + cos(pi * i / decay_iters))``, ``i``
clipped at ``decay_iters - 1``.  The JAX function computes in float32;
this one does too, operation for operation, so the two agree at every
step.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["warmup_cosine_schedule"]

_F = np.float32


def warmup_cosine_schedule(warmup_epochs: int, warmup_lr: float,
                           num_epochs: int, base_lr: float, final_lr: float,
                           iter_per_epoch: int):
    """Per-update schedule ``step -> lr`` (a Python float)."""
    warmup_iters = iter_per_epoch * warmup_epochs
    decay_iters = iter_per_epoch * (num_epochs - warmup_epochs)

    def schedule(step) -> float:
        step = _F(step)
        if step < warmup_iters:
            if warmup_iters > 1:
                lr = (_F(base_lr - warmup_lr) * step / _F(warmup_iters - 1)
                      + _F(warmup_lr))
            else:
                lr = _F(base_lr)
            return float(lr)
        i = np.clip(step - _F(warmup_iters), _F(0), _F(max(decay_iters - 1, 1)))
        cos = _F(math.cos(_F(math.pi) * i / _F(max(decay_iters, 1))))
        return float(_F(final_lr) + _F(0.5 * (base_lr - final_lr))
                     * (_F(1.0) + cos))

    return schedule
