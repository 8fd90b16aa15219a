"""Train and eval steps (port of ``research_image_retrieval_tpu/train/loop.py``).

The JAX step is one jitted program under ``jax.value_and_grad``; here the
forward, ``backward()`` and the optimizer run eagerly on cuDNN, cuBLAS
and autograd, all inside one ``fp32_precision()`` block: autograd runs
the backward convolutions after the forward's own block has closed, and
cuDNN's TF32 default would be back on there.  A model built with
``dtype=bfloat16`` runs its backbone in bf16 (``models/backbone.py``);
the loss, the gradients of the fp32 parameters and the optimizer stay
fp32, as in the JAX step.  ``teacher_table`` (the frozen
``[num_classes, text_dim]`` teacher embeddings of ``data/teacher.py``)
is held on the model's device; each step gathers ``table[labels]``
there and passes it to the model as ``text_features``, as the JAX step
does (each rank gathers its own rows).

``mesh`` (a ``parallel.mesh.Mesh``; JAX's argument) runs the step over a
``data x model`` layout of processes with JAX's global-array semantics:
each rank takes its rows of the global batch (``parallel.mesh.
data_sharding``), the forward runs under ``collectives.active_mesh`` (BN
statistics, MadaCos' and DELG's batch statistics over the data group;
the classifier ``shard_train_state`` split on its feature dimension
reduced over the model group), ``backward()`` is followed by one
bucketed ``all_reduce`` per dtype that averages the gradients over the
data group (no DDP wrapper: it would fight the BN and the sharded head),
and the metrics are the global batch's.  At world size 1 every
collective is exact and the step equals the plain one bit for bit.
JAX's ``donate`` has no counterpart (the state is updated in place).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.convert import training_init
from research_image_retrieval_tpu_torch.ops.losses import topk_errors
from research_image_retrieval_tpu_torch.ops.norm import fused_input_norm
from research_image_retrieval_tpu_torch.parallel.mesh import (
    shard_train_state_rules,
)
from research_image_retrieval_tpu_torch.train.optimizer import (
    Optimizer,
    Transform,
)
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import fp32_precision
from research_image_retrieval_tpu_torch.utils.profiling import span

__all__ = ["TrainState", "create_train_state", "make_eval_step",
           "make_train_step", "shard_train_state"]


@dataclasses.dataclass
class TrainState:
    """Everything a resumable train step needs: the model (parameters and
    BN statistics), the optimizer state, the step count and the step's
    random generator (split once per step, as the JAX step splits its
    key, so a resume continues the same stream; each step's draw seeds
    the generator a dropout model's forward takes).  ``shards`` maps the
    names of column-sharded parameters to the columns this rank holds
    (``shard_train_state``); ``state_dict`` gathers them whole, so a
    checkpoint loads at any layout, and ``load_state_dict`` slices them
    back."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    rng: torch.Generator
    shards: dict = dataclasses.field(default_factory=dict)
    shard_group: object = None

    def state_dict(self) -> dict:
        """Everything to resume from, whole (with shards: a collective,
        every rank of the layout calls it)."""
        model = {}
        for k, v in self.model.state_dict().items():
            if k in self.shards:
                cols, full = self.shards[k]
                v = collectives.gather_columns(v, cols, full,
                                               self.shard_group)
            model[k] = v.detach().cpu()
        return {"step": self.step, "model": model,
                "optimizer": self.optimizer.state_dict(),
                "rng": self.rng.get_state()}

    def load_state_dict(self, state: dict):
        model = dict(state["model"])
        for k, (cols, _) in self.shards.items():
            if model[k].shape[-1] != cols.stop - cols.start:
                model[k] = model[k][..., cols].contiguous()
        self.model.load_state_dict(model)
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


def shard_train_state(state: TrainState, mesh,
                      classifier_key: str = "classifier_w") -> TrainState:
    """Keep this rank's columns of the parameters ``mesh``'s rules shard
    (``parallel.mesh.shard_train_state_rules``: the classifier weight on
    its feature dimension over a model axis longer than 1) and tell the
    optimizer; before the first step, on every rank."""
    rule = shard_train_state_rules(mesh, classifier_key)
    shards, params = {}, {}
    for name, p in state.model.named_parameters():
        cols = rule(name, p)
        if cols is None:
            continue
        full = p.shape[-1]
        with torch.no_grad():
            p.data = p.data[..., cols].contiguous()
        shards[name] = (cols, full)
        params[p] = (cols, full)
    state.shards = shards
    state.shard_group = mesh.group("model") if shards else None
    state.optimizer.set_sharding(params, state.shard_group)
    return state


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


class _Layout:
    """The per-step collectives of a layout: the data rows check, the
    gradient average and the global metrics (all identities without
    a mesh)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.checked = False
        if mesh is not None:
            self.group = mesh.group("data")
            self.size = mesh.shape["data"]

    def check_rows(self, n: int, device):
        """Once: every data rank holds the same number of rows (the BN and
        loss means over equal shards are the global batch's)."""
        if self.mesh is None or self.checked:
            return
        t = torch.tensor([n, n * n], dtype=torch.float64, device=device)
        collectives.all_reduce_(t, self.group)
        if float(t[0]) != self.size * n or float(t[1]) != self.size * n * n:
            raise ValueError(f"data ranks hold unequal shards ({n} rows "
                             f"here, {float(t[0])} over {self.size} ranks)")
        self.checked = True

    def average(self, model):
        if self.mesh is not None:
            collectives.average_gradients(
                [p for p in model.parameters() if p.requires_grad],
                self.group, self.size)

    def metrics(self, values: dict) -> dict:
        if self.mesh is None:
            return values
        keys = list(values)
        t = torch.stack([values[k].detach().to(torch.float64)
                         for k in keys])
        collectives.all_reduce_(t, self.group)
        t /= self.size
        return {k: v.to(values[k].dtype) for k, v in zip(keys, t)}


def make_train_step(input_norm=None, teacher_table=None, mesh=None):
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
    is updated in place and returned.  With ``mesh`` the step takes this
    rank's rows of the global batch and returns the global batch's
    metrics (see the module docstring); ``grad_norm`` is then the norm
    of the averaged gradients, as JAX's.  Spans (``utils.profiling.span``):
    ``train.step`` (its id the step count before it) holding
    ``train.forward``, ``train.backward`` (with the gradient average) and
    ``train.optimizer``."""
    prep = fused_input_norm(input_norm)
    teacher = _Teacher(teacher_table)
    layout = _Layout(mesh)

    def step_fn(state: TrainState, images, labels):
        with span("train.step", id=state.step):
            return _step(state, images, labels)

    def _step(state: TrainState, images, labels):
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
        layout.check_rows(x.shape[0], dev)
        with fp32_precision(), collectives.active_mesh(mesh):
            opt.zero_grad()
            with span("train.forward"):
                loss, logits, *model_state = model(prep(x), y, train=True,
                                                   **kw)
            with span("train.backward"):
                loss.backward()
                layout.average(model)
            with span("train.optimizer"):
                grad_norm = opt.step()
        with torch.no_grad():
            for name, value in (model_state[0] if model_state else {}).items():
                _unwrapped(model).get_buffer(name).copy_(value)
        e1, e5 = topk_errors(logits.detach(), y, ks=(1, 5))
        state.step += 1
        out = layout.metrics({"loss": loss.detach(), "top1_err": e1,
                              "top5_err": e5})
        return state, {**out, "grad_norm": grad_norm}

    return step_fn


def make_eval_step(input_norm=None, teacher_table=None, mesh=None):
    """``step(state, images, labels) -> metrics`` in eval mode (BN
    running statistics, no margin, the fused bottleneck kernel in the
    identity blocks, in its bf16 form for a bf16 model): ``loss``,
    ``top1_err``, ``top5_err``.  ``teacher_table`` as in
    ``make_train_step``, so the validation loss carries the same
    distillation term; ``mesh`` as there (this rank's rows in, the global
    batch's metrics out)."""
    prep = fused_input_norm(input_norm)
    teacher = _Teacher(teacher_table)
    layout = _Layout(mesh)

    def step_fn(state: TrainState, images, labels):
        model = state.model
        x, y = _to_device(images, labels, next(model.parameters()).device)
        model.eval()
        with (torch.no_grad(), fp32_precision(),
              collectives.active_mesh(mesh)):
            loss, logits = model(prep(x), y, train=False,
                                 **teacher.kwargs(y))
        e1, e5 = topk_errors(logits, y, ks=(1, 5))
        return layout.metrics({"loss": loss, "top1_err": e1, "top5_err": e5})

    return step_fn
