"""Optimizers with the JAX package's weight-decay mask, clipping and
accumulation (port of ``research_image_retrieval_tpu/train/optimizer.py``).

A ``Transform`` is the recipe, as an optax ``GradientTransformation`` is:
``Transform.init(model)`` binds it to the model's parameters and returns
the ``Optimizer`` that holds the state.  The JAX chain is
``MultiSteps(chain(clip_by_global_norm, inner))``, and so is this one:

* gradient accumulation (``update_every`` = k): the running mean of the k
  mini-step gradients, ``acc + (g - acc) / (n + 1)`` as ``optax.MultiSteps``
  computes it; one inner update every k steps, and the schedule's count
  advances only on those;
* global-norm clipping of the (accumulated) gradients as optax does it:
  ``g / ||g|| * max_norm`` where ``||g|| >= max_norm``, with no epsilon
  (torch's ``clip_grad_norm_`` adds 1e-6 to the norm, so it is not used);
* the inner update: torch SGD (nesterov, L2 decay added to the gradient
  before the momentum) or AdamW (decoupled decay, ``AdamW`` below), each
  with two parameter groups, because a parameter of rank <= 1 takes no
  decay.

A ``Transform`` made by ``train/freeze.apply_freeze`` carries a
``mask_fn``: the parameters it marks False stay out of all three (the
``set_to_zero`` branch of the JAX package's ``optax.multi_transform``).

Over a ``data x model`` layout (``parallel/mesh.py``) a column-sharded
parameter (``Optimizer.set_sharding``) keeps its slots sharded with it;
the global norm sums its squares over the model group, so clipping sees
JAX's global norm, and ``state_dict`` gathers the slots whole (a
checkpoint loads at any layout).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.utils import collectives

__all__ = ["AdamW", "Optimizer", "Transform", "global_norm", "make_adamw_optimizer",
           "make_sgd_optimizer", "weight_decay_mask"]


def weight_decay_mask(named_params) -> dict:
    """``{name: True}`` where decay applies: not on any parameter of rank
    <= 1 (biases, BN scales, a GeM p)."""
    return {n: p.ndim > 1 for n, p in named_params}


def global_norm(tensors, sharded=None, group=None) -> torch.Tensor:
    """``sqrt(sum ||t||^2)`` over the tensors, as a device scalar in their
    dtype.  On the CPU each tensor's norm accumulates in float64: torch's
    float32 CPU norm of a 2.4M-element tensor is ~4e-5 from the exact
    value, which moves every clipped update by as much against optax.
    ``sharded`` ([bool] per tensor) marks the shards whose squares are
    summed over ``group`` (the other ranks hold the rest of them)."""
    acc = torch.float64 if tensors[0].device.type == "cpu" else None
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=acc)
                         for t in tensors])
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(norms).to(tensors[0].dtype)
    mask = torch.tensor(sharded, device=norms.device)
    sq = norms * norms
    shard_sq = collectives.all_reduce_(sq[mask].sum(), group)
    return torch.sqrt(sq[~mask].sum() + shard_sq).to(tensors[0].dtype)


class AdamW(torch.optim.Optimizer):
    """AdamW as ``optax.adamw`` computes it (eps 1e-8, eps_root 0):
    ``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, with the bias
    corrections ``1 - b^t`` taken in float32 as optax takes them (at
    b2 = 0.999 that rounding moves ``v_hat`` by ~1e-5 against the float64
    correction of ``torch.optim.AdamW``, which therefore drifts from optax
    beyond 1e-6 in a few steps)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                g, mu, nu = p.grad, st["exp_avg"], st["exp_avg_sq"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                t = torch.tensor(st["step"], dtype=torch.float32)
                bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
                bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
                u = (mu / bc1.to(p.device)) / (
                    torch.sqrt(nu / bc2.to(p.device)) + eps)
                if wd:
                    u.add_(p, alpha=wd)
                p.add_(u, alpha=-lr)


class Transform:
    """An optimizer recipe: ``kind`` ("sgd" or "adamw") with its
    hyperparameters, a learning rate that is a float or a schedule of the
    update count, clipping and accumulation."""

    def __init__(self, kind: str, learning_rate: float | Callable,
                 weight_decay: float, clip_max_norm: float = 0.0,
                 update_every: int = 1, **hyper):
        if kind not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer kind {kind!r}")
        self.kind = kind
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_max_norm = clip_max_norm or 0.0
        self.update_every = max(int(update_every or 1), 1)
        self.hyper = hyper
        self.mask_fn = None  # train/freeze.apply_freeze sets it

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, model: nn.Module) -> "Optimizer":
        trainable = None if self.mask_fn is None else self.mask_fn(model)
        return Optimizer(self, list(model.named_parameters()), trainable)


class Optimizer:
    """The state of a ``Transform`` bound to parameters.  Call
    ``zero_grad()``, backward, then ``step()``.  ``trainable`` (``{name:
    bool}``, default all) leaves the False ones unchanged: no update,
    decay or state."""

    def __init__(self, tx: Transform, named_params,
                 trainable: dict | None = None):
        self.tx = tx
        self.params = [p for _, p in named_params]
        if trainable is not None:
            named_params = [(n, p) for n, p in named_params if trainable[n]]
        self.trained = [p for _, p in named_params]
        mask = weight_decay_mask(named_params)
        groups = [
            {"params": [p for n, p in named_params if mask[n]],
             "weight_decay": tx.weight_decay},
            {"params": [p for n, p in named_params if not mask[n]],
             "weight_decay": 0.0},
        ]
        lr0 = tx.lr(0)
        if tx.kind == "sgd":
            # optax.sgd(momentum, nesterov) after add_decayed_weights ==
            # torch SGD with dampening=0: the trace starts at 0, so both
            # take buf = g + wd*p on the first step, buf = mu*buf + d
            # after, and update with d + mu*buf
            self.inner = torch.optim.SGD(
                groups, lr=lr0, momentum=tx.hyper.get("momentum", 0.9),
                dampening=0.0, nesterov=tx.hyper.get("nesterov", True))
        else:
            self.inner = AdamW(groups, lr=lr0,
                               betas=(tx.hyper.get("b1", 0.9),
                                      tx.hyper.get("b2", 0.999)))
        self.count = 0       # inner updates made: the schedule's step
        self.mini_step = 0   # position inside an accumulation window
        self.acc = None      # running mean of the window's gradients
        self.shards: dict = {}  # id(param) -> (columns, full width)
        self.shard_group = None

    def set_sharding(self, shards: dict, group):
        """Mark column-sharded parameters: ``shards`` maps a parameter to
        ``(columns it holds, full width)``; ``group`` holds the rest."""
        self.shards = {id(p): v for p, v in shards.items()}
        self.shard_group = group

    def _sharded(self, params) -> list | None:
        return [id(p) in self.shards for p in params] if self.shards else None

    def _gather(self, p, t):
        """A slot ``t`` of ``p`` whole (gathered over the shard group)."""
        if (id(p) not in self.shards or not torch.is_tensor(t)
                or t.shape != p.shape):
            return t
        cols, full = self.shards[id(p)]
        return collectives.gather_columns(t, cols, full, self.shard_group)

    def _scatter(self, p, t):
        """This rank's columns of a whole slot ``t`` of ``p``."""
        if (id(p) not in self.shards or not torch.is_tensor(t)
                or t.shape == p.shape):
            return t
        return t[..., self.shards[id(p)][0]].contiguous()

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply this mini-step's gradients; returns their global norm
        (raw, before accumulation and clipping) as a device scalar.  Each
        ``p.grad`` holds its raw gradient again afterwards."""
        raw = [p.grad if p.grad is not None else torch.zeros_like(p)
               for p in self.params]
        try:
            return self._step(raw)
        finally:
            for p, g in zip(self.params, raw):
                p.grad = g

    def _step(self, grads) -> torch.Tensor:
        raw_norm = global_norm(grads, self._sharded(self.params),
                               self.shard_group)
        if len(self.trained) < len(self.params):  # a frozen mask
            ids = {id(p) for p in self.trained}
            grads = [g for p, g in zip(self.params, grads) if id(p) in ids]
        k = self.tx.update_every
        if k > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return raw_norm
            grads = self.acc
        norm = (raw_norm if k == 1 and len(self.trained) == len(self.params)
                else global_norm(grads, self._sharded(self.trained),
                                 self.shard_group))
        max_norm = self.tx.clip_max_norm
        for p, g in zip(self.trained, grads):
            if max_norm > 0:
                g = torch.where(norm < max_norm, g, g / norm * max_norm)
            p.grad = g
        lr = self.tx.lr(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        if k > 1:
            self.acc = None  # optax zeroes the window after an update
        return raw_norm

    def _inner_params(self) -> list:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        """The state, sharded slots gathered whole (a collective: every
        rank of the layout calls it)."""
        inner = self.inner.state_dict()
        acc = self.acc
        if self.shards:
            order = self._inner_params()
            inner["state"] = {
                i: {k: self._gather(order[i], v) for k, v in st.items()}
                for i, st in inner["state"].items()}
            if acc is not None:
                acc = [self._gather(p, a) for p, a in zip(self.trained, acc)]
        return {"kind": self.tx.kind, "count": self.count,
                "mini_step": self.mini_step, "acc": acc, "inner": inner}

    def load_state_dict(self, state: dict):
        if state["kind"] != self.tx.kind:
            raise ValueError(f"optimizer state of kind {state['kind']!r} "
                             f"cannot load into {self.tx.kind!r}")
        inner, acc = state["inner"], state["acc"]
        if self.shards:
            order = self._inner_params()
            inner = {**inner, "state": {
                i: {k: self._scatter(order[int(i)], v) for k, v in st.items()}
                for i, st in inner["state"].items()}}
            if acc is not None:
                acc = [self._scatter(p, a) for p, a in zip(self.trained, acc)]
        self.inner.load_state_dict(inner)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        dev = self.params[0].device
        self.acc = None if acc is None else [a.to(dev) for a in acc]


def make_sgd_optimizer(learning_rate, momentum: float = 0.9,
                       weight_decay: float = 1e-4, nesterov: bool = True,
                       clip_max_norm: float = 0.0,
                       update_every: int = 1) -> Transform:
    """torch-style SGD: grad += wd * param (masked), then (nesterov)
    momentum, then lr."""
    return Transform("sgd", learning_rate, weight_decay, clip_max_norm,
                     update_every, momentum=momentum, nesterov=nesterov)


def make_adamw_optimizer(learning_rate, weight_decay: float = 0.05,
                         b1: float = 0.9, b2: float = 0.999,
                         clip_max_norm: float = 0.0,
                         update_every: int = 1) -> Transform:
    """AdamW with decoupled, masked decay."""
    return Transform("adamw", learning_rate, weight_decay, clip_max_norm,
                     update_every, b1=b1, b2=b2)
