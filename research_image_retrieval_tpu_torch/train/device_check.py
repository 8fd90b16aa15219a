"""The train step on the card against the same step on the CPU.

One SGD step of a registry model (default GeM-R50; any other with
``model_overrides``, and a distillation model with a teacher table
gathered in the step) with ``TrainConfig``'s hyperparameters (lr 0.01,
nesterov momentum 0.9, weight decay 1e-4, clip 1.0) at a reduced size
(batch 2, 128 px, ResNet-50, 512 classes), from one state and batch on
both devices:

* in float64, where the comparison is well conditioned: on the CPU, one
  ulp of the input moves a gradient leaf by ~4e-13 of its largest
  magnitude and the loss by ~3e-15 (in float32 the same ulp moves the
  whole gradient by ~1.6%, because train-mode BN at init amplifies
  rounding).  Every leaf is held to a fixed bar (``BARS``): the loss and
  grad_norm, relative; each gradient leaf, relative to its largest
  magnitude; what the step moved in each parameter, relative to its
  largest change; the running statistics, relative to each leaf's
  largest magnitude.  A gradient or change leaf that is zero by
  construction (a convolution's bias feeding a train-mode BN, as in
  HAMLET's context block: BN removes the mean, so only float64 rounding
  is left, ~1e-19 of the step's largest gradient) has no scale of its
  own: the leaves below ``BARS["zero leaves"]`` of the largest leaf's
  magnitude on the CPU are held to stay below it on the card too.
* in float32 on the card with TF32 switched on for cuDNN and cuBLAS
  around the call, to show that the step turns it off for the forward,
  ``backward()`` and the optimizer (a hook on the output of the first
  convolution, the stem, whose gradient autograd computes last, records
  the flags) and restores the
  caller's flags afterwards.  TF32 does not apply to float64, so only
  this run can show it.

Two models have a rule of their own (``RULES``), each from what its
step computes; every other model is held to ``BARS`` alone:

* ``token_r101``: its transformer's first BN sees a train-mode BN's
  output, so that BN's running mean is zero by construction, rounding
  noise on either device; running statistics below ``BARS["zero
  leaves"]`` of the largest running statistic on the CPU are held at
  the zero-leaf bar.  Its grad_norm sums the gradients of flax's
  ``E[x^2] - E[x]^2`` in its LayerNorm and token BN, which cancel: the
  CPU's own floor (the same step on the reversed batch in one thread) is
  measured in the check and printed, and grad_norm is held to 10x that
  floor where that is above ``BARS["grad_norm"]``.
* ``spca_r101`` has no rule: its distance masks are built in the head's
  dtype (``models/spca.py``), so a float64 step rounds them alike on
  both devices.

Run it with ``check_cuda_train_step()`` (or ``check_cuda_train_step(
"sparse_r50", teacher_table=...)``); it raises on a miss.  A model that
drops is checked with every rate at 0 (``rate``, ``drop``,
``attn_drop``, ``proj_drop`` and ``dropout`` of its modules): the card's
generator draws other bits than the CPU's.  ``optimizers=("adamw",
"sgd")`` takes one step of each, the second after the driver's hand-off
(a fresh optimizer on the same parameters, as ULTRON's ``adamw_then_sgd``
switches): every step's gradients are compared, and the changes of all
steps together.  Under AdamW the update of a zero-by-construction leaf
is ``lr * g / (|g| + eps)`` of its rounding noise, any size up to the
learning rate and of either sign: such a leaf's gradient is held at
the zero-leaf bar in that step, and its change is not compared.
"""

from __future__ import annotations

import numpy as np
import torch

from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.models import get_model
from research_image_retrieval_tpu_torch.train.loop import (
    create_train_state,
    make_train_step,
)
from research_image_retrieval_tpu_torch.train.optimizer import (
    make_adamw_optimizer,
    make_sgd_optimizer,
)
from research_image_retrieval_tpu_torch.utils.config import TrainConfig

__all__ = ["BARS", "RULES", "SHAPE", "check_cuda_train_step"]

SHAPE = dict(batch=2, px=128, classes=512, seed=0)
BARS = {
    "loss": 1e-10,
    "grad_norm": 1e-10,
    "gradient leaves": 1e-8,
    "parameter changes": 1e-6,
    "running statistics": 1e-9,
    "zero leaves": 1e-12,
}


# name -> its own rules (see the module docstring): "zero statistics"
# holds zero-by-construction running statistics at the zero-leaf bar,
# "grad_norm floor" holds grad_norm to that multiple of the CPU's own
# floor where that is above BARS
RULES = {
    "token_r101": {"zero statistics": True, "grad_norm floor": 10.0},
}

_RATES = ("rate", "drop", "attn_drop", "proj_drop", "dropout")


def _no_dropout(model):
    """Every dropout / drop-path rate of ``model``'s modules at 0."""
    for mod in model.modules():
        for attr in _RATES:
            if isinstance(getattr(mod, attr, None), float):
                setattr(mod, attr, 0.0)
    return model


def _optimizer(kind: str):
    cfg = TrainConfig()
    if kind == "adamw":
        return make_adamw_optimizer(cfg.base_lr,
                                    weight_decay=cfg.weight_decay,
                                    clip_max_norm=cfg.clip_max_norm)
    return make_sgd_optimizer(cfg.base_lr, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay,
                              clip_max_norm=cfg.clip_max_norm)


def _step(device: str, dtype: torch.dtype, x: np.ndarray, y: np.ndarray,
          name: str, overrides: dict, table, optimizers=("sgd",),
          on_stem_grad=None) -> dict:
    model = _no_dropout(get_model(name, num_classes=SHAPE["classes"],
                                  **overrides).to(dtype))
    state = create_train_state(model, SHAPE["seed"],
                               _optimizer(optimizers[0]), device=device)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    def on_stem(mod, inputs, out):
        out.register_hook(on_stem_grad)

    hook = None
    if on_stem_grad is not None:  # the first convolution: the stem
        stem = next(m for m in model.modules()
                    if isinstance(m, torch.nn.Conv2d))
        hook = stem.register_forward_hook(on_stem)
    if table is not None:  # the teacher table lives on the step's device
        table = torch.as_tensor(table, dtype=dtype, device=device)
    def cpu(t):
        return t.detach().to("cpu", torch.float64)

    step = make_train_step(None, teacher_table=table)
    grads = []
    for i, kind in enumerate(optimizers):
        if i:  # the hand-off: a fresh optimizer on the same parameters
            state.optimizer = _optimizer(kind).init(model)
            state.step = 0
        state, m = step(state, torch.from_numpy(x).to(dtype), y)
        grads.append({n: cpu(p.grad) for n, p in model.named_parameters()})
        if hook is not None:
            hook.remove()
            hook = None

    return dict(
        loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), grads=grads,
        changes={n: cpu(p) - cpu(init[n]) for n, p in model.named_parameters()},
        stats={k: cpu(v) for k, v in model.state_dict().items()
               if "running" in k})


def _zero_leaves(want: dict) -> set:
    """The leaves whose largest magnitude is below ``BARS["zero
    leaves"]`` of the largest over all leaves."""
    scale = max(float(v.abs().max()) for v in want.values())
    return {k for k, v in want.items()
            if float(v.abs().max()) <= BARS["zero leaves"] * scale}


def _worst_leaf(got: dict, want: dict,
                skip: set = frozenset()) -> tuple[float, str]:
    """The largest ``max |got - want| / max |want|`` over the leaves not
    in ``skip``."""
    devs = {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp(min=1e-300))
            for k in want if k not in skip}
    worst = max(devs, key=devs.get)
    return devs[worst], worst


def _worst_zero_leaf(got: dict, want: dict,
                     zero: set) -> tuple[float, str]:
    """The largest ``max(|got|, |want|)`` over the ``zero`` leaves, over
    the largest magnitude of any leaf on the CPU."""
    if not zero:
        return 0.0, ""
    scale = max(float(v.abs().max()) for v in want.values())
    devs = {k: max(float(got[k].abs().max()), float(want[k].abs().max()))
            / scale for k in zero}
    worst = max(devs, key=devs.get)
    return devs[worst], worst


def _compare(got: dict, want: dict, optimizers,
             zero_stats: bool = False) -> dict:
    """``{check: (deviation, worst leaf or "")}`` of two runs of ``_step``
    (``want`` the reference); ``zero_stats`` holds the running statistics
    that are zero by construction at the zero-leaf bar."""
    rel = lambda a, b: (abs(a - b) / abs(b), "")  # noqa: E731
    zero_grads = [_zero_leaves(g) for g in want["grads"]]
    zero_changes = _zero_leaves(want["changes"])
    zero_running = _zero_leaves(want["stats"]) if zero_stats else set()
    noise_moved = set().union(*(z for z, kind in zip(zero_grads, optimizers)
                                if kind == "adamw")) - zero_changes
    steps = list(zip(got["grads"], want["grads"], zero_grads))
    return {
        "loss": rel(got["loss"], want["loss"]),
        "grad_norm": rel(got["grad_norm"], want["grad_norm"]),
        "gradient leaves": max(_worst_leaf(g, w, z) for g, w, z in steps),
        "parameter changes": _worst_leaf(got["changes"], want["changes"],
                                         zero_changes | noise_moved),
        "running statistics": _worst_leaf(got["stats"], want["stats"],
                                          zero_running),
        "zero leaves": max(
            *(_worst_zero_leaf(g, w, z) for g, w, z in steps),
            _worst_zero_leaf(got["changes"], want["changes"], zero_changes),
            _worst_zero_leaf(got["stats"], want["stats"], zero_running)),
    }


def check_cuda_train_step(name: str = "gem_r50",
                          model_overrides: dict | None = None,
                          teacher_table=None,
                          optimizers=("sgd",)) -> dict:
    """``{check: (deviation, bar, worst leaf or "")}`` of the float64
    CUDA step of ``name`` (built with ``model_overrides``; with
    ``teacher_table`` [SHAPE classes, text_dim] gathered by label in the
    step; one step per entry of ``optimizers``) against the CPU's, after
    the float32 TF32 check; raises ``AssertionError`` on any miss."""
    kw = dict(name=name, overrides=dict(model_overrides or {}),
              table=teacher_table, optimizers=tuple(optimizers))
    rng = np.random.default_rng(SHAPE["seed"])
    B, px = SHAPE["batch"], SHAPE["px"]
    x = (rng.integers(0, 256, (B, px, px, 3)) / 255.0
         - IMAGENET_MEAN) / IMAGENET_STD
    y = rng.integers(0, SHAPE["classes"], B)

    flags = []

    def record(grad):
        flags.append((torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32))

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fp32 = _step("cuda", torch.float32, x.astype(np.float32), y,
                     on_stem_grad=record, **kw)
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    if not flags or any(any(f) for f in flags) or after != (True, True):
        raise AssertionError(f"TF32 flags during the backward {flags}, after "
                             f"the step {after} (want off, then restored)")
    bad = [n for n, g in fp32["grads"][-1].items()
           if not bool(g.isfinite().all())]
    if not np.isfinite(fp32["loss"]) or bad:
        raise AssertionError(f"float32 step: loss {fp32['loss']}, non-finite "
                             f"gradients in {bad[:5]}")

    rule = RULES.get(name, {})
    want = _step("cpu", torch.float64, x, y, **kw)
    got = _step("cuda", torch.float64, x, y, **kw)
    devs = _compare(got, want, kw["optimizers"],
                    zero_stats=rule.get("zero statistics", False))
    bars = dict(BARS)
    if "grad_norm floor" in rule:  # the CPU against itself
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            other = _step("cpu", torch.float64, x[::-1].copy(), y[::-1].copy(),
                          **kw)
        finally:
            torch.set_num_threads(threads)
        floor = abs(other["grad_norm"] - want["grad_norm"]) / abs(
            want["grad_norm"])
        bars["grad_norm"] = max(BARS["grad_norm"],
                                rule["grad_norm floor"] * floor)
        devs["grad_norm"] = (devs["grad_norm"][0], f"CPU floor {floor:.2e}")
    out = {k: (d, bars[k], leaf) for k, (d, leaf) in devs.items()}
    miss = {k: v for k, v in out.items() if not v[0] <= v[1]}
    if miss:
        raise AssertionError(f"{name}: float64 train step, cuda vs cpu "
                             f"(deviation, bar, worst leaf): {miss}")
    return out
