"""Training as ``cli.train`` steps it: ``train.loop.make_train_step`` over
seeded uint8 batches already on the device, so the step, not the host
pipeline, sets the pace.

Set-up builds one training state (the port's model holding the
benchmark's weights, the SGD optimizer with Nesterov momentum, weight
decay and global-norm clipping) and drives it through the window's own
step over the first ``checked_steps`` batches of the feed, whose rows
all differ; the same state goes on into the window.  The window runs
whole steps until ``--seconds`` have passed, cycling a feed of
``feed_batches`` batches; ``train_img_per_s`` is its images over its
time, the last step waited for.

Mix parameters: ``batch``, ``image_size``, ``lr``, ``momentum``,
``weight_decay``, ``clip``, ``feed_batches``, ``checked_steps``,
``loss_steps``, ``noise``; ``stretch_at`` (share of the window) and ``stretch_steps`` of
the traced stretch.

Correctness, against ``reference.resnet_gem.train_steps`` over the same
weights and batches: ``loss_rel_gap``, the largest relative gap of the
loss of the first ``loss_steps`` checked steps (the later steps' gaps,
printed beside it, carry fp32 round-off amplified by the updates: the
two sides agree to 1e-12 in float64); ``grad_leaf_gap``, the worst leaf's gap between
the norms of the first step's gradient as the optimizer took it (worked
out from its momentum after one step: ``buffer - weight_decay * p0``)
and the reference's; ``update_leaf_gap``, the worst leaf's gap between
the norms of the change of each parameter and BN running statistic over
the checked steps, read before the next step.  Both leaf gaps are taken
against the larger of that leaf's reference norm and the median leaf's;
parameters whose reference gradient is under a thousandth of the median
leaf's are left out of the change, since round-off alone moves them.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.drivers import common
from perfbench.harness import Outcome
from perfbench.reference import resnet_gem as ref
from perfbench.trace import Stretch

__all__ = ["leaf_gaps", "run", "step_ops"]


def step_ops(cfg: dict, mix: dict) -> float:
    """Operations of one step: three times the forward's multiply-adds
    (backbone, whitening, ArcFace product) per image, two per MAC."""
    return 2.0 * 3 * mix["batch"] * work.retrieval_macs(
        cfg["depths"], mix["image_size"], mix["image_size"],
        whiten=cfg["outputdim"], classes=cfg["num_classes"])


def _opt(mix: dict) -> dict:
    return {k: mix[k] for k in ("lr", "momentum", "weight_decay", "clip")}


def _batches(cell):
    cfg, mix = cell.config, cell.traffic
    return inputs.train_batches(
        mix["feed_batches"], mix["batch"], mix["image_size"],
        cfg["num_classes"], inputs.sub_seed(cell.seed, "batches"),
        cell.device, noise=mix["noise"])


def leaf_gaps(got: dict, want: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's ``|got - want| / max(want, median want)`` over the
    leaves in ``keep`` (default all), and its name."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    worst, name = 0.0, ""
    for k in keys:
        g = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if not np.isfinite(got[k]):
            g = float("inf")
        if g >= worst:
            worst, name = g, k
    return worst, name


def reference_readings(cell, precision: str = "fp32",
                       rows: int | None = None) -> dict:
    """The reference's losses, first gradient norms and change norms per
    leaf over the checked steps (``precision`` and ``rows`` plant the
    control and the half-batch fault)."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    p0 = inputs.resnet_gem_weights(cfg, inputs.sub_seed(cell.seed,
                                                        "weights"), dev)
    start = {k: v.clone() for k, v in p0.items() if v.is_floating_point()}
    feed = _batches(cell)[:mix["checked_steps"]]
    out = ref.train_steps(p0, feed, cfg, _opt(mix), inputs.IMAGENET_MEAN,
                          inputs.IMAGENET_STD, precision=precision, rows=rows)
    grads = {k: float(torch.linalg.vector_norm(g))
             for k, g in out["first_grads"].items()}
    change = {k: float(torch.linalg.vector_norm(v - start[k]))
              for k, v in out["final"].items()}
    return {"losses": out["losses"], "grads": grads, "change": change}


def compare(got: dict, want: dict, loss_steps: int) -> tuple[dict, list]:
    """The three compared numbers of ``got`` readings against ``want``'s
    (the loss over the first ``loss_steps`` steps), and a note naming the
    worst leaves and every step's loss gap."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                want["losses"])]
    loss = max(gaps[:loss_steps])
    if not all(np.isfinite(got["losses"])):
        loss = float("inf")
    grad, g_name = leaf_gaps(got["grads"], want["grads"])
    med = statistics.median(want["grads"].values())
    keep = {k for k in want["change"]
            if k not in want["grads"] or want["grads"][k] >= 1e-3 * med}
    upd, u_name = leaf_gaps(got["change"], want["change"], keep)
    dropped = sorted(set(want["change"]) - keep)

    def worst3(key, names):
        rel = sorted(((abs(got[key][k] - want[key][k]) / want[key][k], k)
                      for k in names if want[key][k] > 0), reverse=True)[:3]
        return ", ".join(f"{k} {got[key][k]!r} vs {want[key][k]!r}"
                         for _, k in rel)

    note = (f"losses {got['losses']} vs {want['losses']} (relative gaps "
            f"{gaps}); worst gradient "
            f"leaf {g_name}, worst change leaf {u_name}; left out of the "
            f"change (reference gradient < 1e-3 x median): {dropped}; "
            f"by own norm, gradients: {worst3('grads', want['grads'])}; "
            f"changes: {worst3('change', keep)}")
    return {"loss_rel_gap": loss, "grad_leaf_gap": grad,
            "update_leaf_gap": upd}, [note]


def run(cell) -> Outcome:
    from research_image_retrieval_tpu_torch.train import loop as tl
    from research_image_retrieval_tpu_torch.train import optimizer as topt

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    p0 = inputs.resnet_gem_weights(cfg, inputs.sub_seed(cell.seed,
                                                        "weights"), dev)
    model = common.port_model(cfg, p0, dev)
    tx = topt.make_sgd_optimizer(mix["lr"], momentum=mix["momentum"],
                                 weight_decay=mix["weight_decay"],
                                 nesterov=True, clip_max_norm=mix["clip"])
    state = tl.TrainState(step=0, model=model, optimizer=tx.init(model),
                          rng=torch.Generator().manual_seed(
                              inputs.sub_seed(cell.seed, "step")))
    step = tl.make_train_step(input_norm=(
        np.array(inputs.IMAGENET_MEAN, np.float32),
        np.array(inputs.IMAGENET_STD, np.float32)))
    feed = _batches(cell)
    F = len(feed)

    # the checked steps: the window's own call and feed
    losses, grads = [], None
    params = dict(model.named_parameters())
    for s in range(mix["checked_steps"]):
        state, m = step(state, *feed[s % F])
        losses.append(float(m["loss"]))
        if s == 0:
            grads = {}
            with torch.no_grad():
                for k, p in params.items():
                    buf = state.optimizer.inner.state.get(p, {}).get(
                        "momentum_buffer")
                    if buf is None:  # no update was made
                        grads[k] = float("nan")
                        continue
                    g = buf - mix["weight_decay"] * p0[k] if p.dim() > 1 \
                        else buf
                    grads[k] = float(torch.linalg.vector_norm(g))
    with torch.no_grad():
        now = {**params, **dict(model.named_buffers())}
        change = {k: float(torch.linalg.vector_norm(now[k] - p0[k]))
                  for k in p0 if p0[k].is_floating_point()}
    got = {"losses": losses, "grads": grads, "change": change}
    del p0, now
    stretch = Stretch(dev)
    if cell.trace:
        stretch.prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    n, k0, in_stretch, window_losses = 0, mix["checked_steps"], 0, []
    while time.perf_counter() - t0 < cell.seconds:
        if cell.trace and stretch.prof is None and \
                time.perf_counter() - t0 >= mix["stretch_at"] * cell.seconds:
            stretch.start()
        state, m = step(state, *feed[(k0 + n) % F])
        window_losses.append(m["loss"])
        n += 1
        if stretch.active:
            in_stretch += 1
            if in_stretch == mix["stretch_steps"]:
                stretch.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if stretch.active:
        stretch.stop()
    peak = common.memory_peak(dev)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    obs, notes = {}, []
    if cell.trace and stretch.prof is not None:
        obs = {"trace": stretch.summary(),
               "stretch_ops": in_stretch * step_ops(cfg, mix)}
        notes.append(f"stretch {obs['trace']['window_s']:.3f} s over "
                     f"{in_stretch} steps, {obs['trace']['n_device_ops']} "
                     "device ops")
    notes.append(f"window {t1 - t0:.3f} s, {n} steps of {mix['batch']}, "
                 f"{n * step_ops(cfg, mix) / (t1 - t0) / 1e12:.2f} TFLOP/s, "
                 f"memory peak {peak}")
    del state, model, params, step, feed, tx, m, window_losses
    common.free(dev)

    want = reference_readings(cell)
    checks, more = compare(got, want, mix["loss_steps"])
    return Outcome(
        attempted=n, failed=failed,
        metrics={"train_img_per_s": n * mix["batch"] / (t1 - t0)},
        checks={k: (v, cell.limits[k]) for k, v in checks.items()},
        setup_end=t0, memory_peak_bytes=peak, obs=obs, notes=notes + more)
