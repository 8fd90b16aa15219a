"""Train and eval steps (port of ``research_image_retrieval_tpu/train/loop.py``).

The JAX step is one jitted program under ``jax.value_and_grad``; here the
forward, ``backward()`` and the optimizer run eagerly on cuDNN, cuBLAS
and autograd, all inside one ``fp32_precision()`` block: autograd runs
the backward convolutions after the forward's own block has closed, and
cuDNN's TF32 default would be back on there.  A model built with
``dtype=bfloat16`` runs its backbone in bf16 (``models/backbone.py``);
the loss, the gradients of the fp32 parameters and the optimizer stay
fp32, as in the JAX step.  One device, no mesh: the JAX ``mesh`` and
``donate`` arguments are not ported.  ``teacher_table`` (the frozen
``[num_classes, text_dim]`` teacher embeddings of ``data/teacher.py``)
is held on the model's device; each step gathers ``table[labels]``
there and passes it to the model as ``text_features``, as the JAX step
does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.convert import training_init
from research_image_retrieval_tpu_torch.ops.losses import topk_errors
from research_image_retrieval_tpu_torch.ops.norm import fused_input_norm
from research_image_retrieval_tpu_torch.train.optimizer import (
    Optimizer,
    Transform,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["TrainState", "create_train_state", "make_eval_step",
           "make_train_step"]


@dataclasses.dataclass
class TrainState:
    """Everything a resumable train step needs: the model (parameters and
    BN statistics), the optimizer state, the step count and the step's
    random generator (split once per step, as the JAX step splits its
    key, so a resume continues the same stream; each step's draw seeds
    the generator a dropout model's forward takes)."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    rng: torch.Generator

    def state_dict(self) -> dict:
        return {"step": self.step,
                "model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "rng": self.rng.get_state()}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.rng.set_state(state["rng"])


def create_train_state(model: nn.Module, seed: int, tx: Transform,
                       device="cuda") -> TrainState:
    """Initialize ``model`` as the JAX models are initialized
    (``training_init``, from a generator seeded with ``seed``), move it to
    ``device`` and bind ``tx`` to its parameters.  Other weights (a
    checkpoint, converted JAX variables) load into ``state.model``
    afterwards; the optimizer holds the same tensors."""
    gen = torch.Generator().manual_seed(seed)
    training_init(model, gen)
    model.to(device)
    rng = torch.Generator().manual_seed(int(torch.randint(
        2 ** 62, (1,), generator=gen)))
    return TrainState(step=0, model=model, optimizer=tx.init(model), rng=rng)


def _to_device(images, labels, device):
    """numpy batches or tensors (on any device) -> tensors on ``device``."""
    x = torch.as_tensor(images).to(device, non_blocking=True)
    y = torch.as_tensor(labels).to(device, torch.int64, non_blocking=True)
    return x, y


def _unwrapped(model: nn.Module) -> nn.Module:
    """The module a DDP or ``torch.compile`` wrapper holds, or ``model``."""
    for attr in ("module", "_orig_mod"):
        model = getattr(model, attr, model)
    return model


def _takes_generator(model: nn.Module) -> bool:
    """Whether ``model`` draws its dropout from a per-step generator:
    such a model declares ``takes_generator = True``."""
    return bool(getattr(_unwrapped(model), "takes_generator", False))


class _Teacher:
    """A teacher table moved to the model's device once (on first use)
    and gathered there by label."""

    def __init__(self, table):
        self.table = None if table is None else torch.as_tensor(table)

    def kwargs(self, labels: torch.Tensor) -> dict:
        if self.table is None:
            return {}
        if self.table.device != labels.device:
            self.table = self.table.to(labels.device)
        return {"text_features": self.table[labels]}


def make_train_step(input_norm=None, teacher_table=None):
    """``step(state, images, labels) -> (state, metrics)``: uint8 (or
    normalized float) NHWC batches in, normalized on the device with
    ``input_norm=(mean, std)``; one forward, backward and optimizer step,
    fp32 with TF32 off throughout except a bf16 model's backbone.  ``metrics`` are device scalars:
    ``loss``, ``top1_err``, ``top5_err`` and ``grad_norm`` (raw gradients,
    before clipping).  A model whose train forward returns a third value,
    ``{buffer name: new value}`` (RetrievalNet's ``arcface_t``, the JAX
    step's ``model_state``), has those buffers written after the update.
    ``teacher_table`` [num_classes, text_dim] (array or tensor) adds
    ``text_features=table[labels]``, gathered on the device.  The state
    is updated in place and returned."""
    prep = fused_input_norm(input_norm)
    teacher = _Teacher(teacher_table)

    def step_fn(state: TrainState, images, labels):
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        x, y = _to_device(images, labels, dev)
        # the JAX step splits its key every step: this draw seeds the
        # step's dropout generator (on the model's device), so a resumed
        # run drops what the straight run dropped
        seed = int(torch.randint(2 ** 62, (1,), generator=state.rng))
        kw = teacher.kwargs(y)
        if _takes_generator(model):
            kw["generator"] = torch.Generator(device=dev).manual_seed(seed)
        model.train()
        with fp32_precision():
            opt.zero_grad()
            loss, logits, *model_state = model(prep(x), y, train=True, **kw)
            loss.backward()
            grad_norm = opt.step()
        with torch.no_grad():
            for name, value in (model_state[0] if model_state else {}).items():
                _unwrapped(model).get_buffer(name).copy_(value)
        e1, e5 = topk_errors(logits.detach(), y, ks=(1, 5))
        state.step += 1
        return state, {"loss": loss.detach(), "top1_err": e1,
                       "top5_err": e5, "grad_norm": grad_norm}

    return step_fn


def make_eval_step(input_norm=None, teacher_table=None):
    """``step(state, images, labels) -> metrics`` in eval mode (BN
    running statistics, no margin, the fused bottleneck kernel in the
    identity blocks, in its bf16 form for a bf16 model): ``loss``,
    ``top1_err``, ``top5_err``.  ``teacher_table`` as in
    ``make_train_step``, so the validation loss carries the same
    distillation term."""
    prep = fused_input_norm(input_norm)
    teacher = _Teacher(teacher_table)

    def step_fn(state: TrainState, images, labels):
        model = state.model
        x, y = _to_device(images, labels, next(model.parameters()).device)
        model.eval()
        with torch.no_grad(), fp32_precision():
            loss, logits = model(prep(x), y, train=False,
                                 **teacher.kwargs(y))
        e1, e5 = topk_errors(logits, y, ks=(1, 5))
        return {"loss": loss, "top1_err": e1, "top5_err": e5}

    return step_fn
