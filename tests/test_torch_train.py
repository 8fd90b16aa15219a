"""PyTorch port, training on the CPU, held against the JAX package on the
same inputs (made with numpy from a seed):

* losses: ``arcface_logits`` (with rows where theta > pi - m),
  ``cross_entropy``, ``topk_errors`` to 1e-6, their gradients against
  ``jax.grad`` to 1e-5;
* BatchNorm in train mode against flax's at layer4 of a 32 px batch of 4
  (n = 4, so torch's unbiased running variance would be 4/3 too large):
  output and running statistics after 1 and 3 steps to 1e-5;
* the warmup-cosine schedule at every step;
* the optimizers (SGD nesterov with masked decay, AdamW, clipping above
  and below the norm, accumulation over 2 steps) against optax for 5
  steps to 1e-6;
* one train step of gem_r50 on resnet18 (outputdim 16, 8 classes, 32 px
  uint8, batch 4) from one JAX init against JAX ``make_train_step``:
  loss to 1e-5; gradients and BN statistics to 1e-4 of each leaf's
  largest magnitude, and what 1 and 3 steps moved (parameters minus the
  init) to 1e-4 of each leaf's largest change; each bar or 10x JAX's own
  deviation when the inputs move by one ulp where that float32 floor is
  higher (see ``step_pair``);
* the training init's law and shapes; checkpoints and ``partial_load``.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.ops import losses as jl
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.models import (
    BatchNorm,
    from_jax_variables,
    get_model,
    training_init,
)
from research_image_retrieval_tpu_torch.ops import losses as tl
from research_image_retrieval_tpu_torch.train import (
    CheckpointManager,
    create_train_state,
    make_adamw_optimizer,
    make_eval_step,
    make_sgd_optimizer,
    make_train_step,
    partial_load,
    warmup_cosine_schedule,
)
from tests.test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
NORM = (IMAGENET_MEAN, IMAGENET_STD)


def _close(got, want, tol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol, f"{name}: max |err| {err:.3e} > {tol}"


# -- losses -------------------------------------------------------------------

def _arcface_inputs(seed=0, B=6, C=10, D=8, m=0.5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, D)).astype(np.float32)
    weight = rng.standard_normal((C, D)).astype(np.float32)
    labels = rng.integers(0, C, B)
    # rows 0 and 1 point away from their target: theta > pi - m there
    for r in (0, 1):
        feats[r] = -weight[labels[r]] + 0.01 * rng.standard_normal(D)
    return feats, weight, labels


@pytest.mark.parametrize("s, m", [(32.0, 0.15), (64.0, 0.5), (16.0, 0.0)])
def test_arcface_cross_entropy_topk_match_jax(s, m):
    feats, weight, labels = _arcface_inputs(m=m)
    want = np.asarray(jl.arcface_logits(jnp.asarray(feats), jnp.asarray(weight),
                                        jnp.asarray(labels), s=s, m=m))
    got = tl.arcface_logits(T(feats), T(weight), T(labels), s=s, m=m).numpy()
    cos = feats / np.linalg.norm(feats, axis=1, keepdims=True) @ (
        weight / np.linalg.norm(weight, axis=1, keepdims=True)).T
    if m:
        wrapped = np.arccos(cos[np.arange(6), labels]) > math.pi - m
        assert wrapped[:2].all()  # the no-margin branch is exercised
    _close(got / s, want / s, 1e-6, "arcface logits / s")
    # fp32 sums of logits up to 64: 1e-6 of the loss's magnitude
    assert tl.cross_entropy(T(got), T(labels)).item() == pytest.approx(
        float(jl.cross_entropy(jnp.asarray(got), jnp.asarray(labels))),
        rel=1e-6, abs=1e-6)
    for e_t, e_j in zip(tl.topk_errors(T(got), T(labels), ks=(1, 5)),
                        jl.topk_errors(jnp.asarray(got), jnp.asarray(labels),
                                       ks=(1, 5))):
        assert float(e_t) == pytest.approx(float(e_j), abs=1e-6)


def test_loss_gradients_match_jax():
    feats, weight, labels = _arcface_inputs(seed=1)
    probe = np.random.default_rng(2).standard_normal((6, 10)).astype(np.float32)
    s, m = 32.0, 0.15

    def jax_loss(f, w):
        lg = jl.arcface_logits(f, w, jnp.asarray(labels), s=s, m=m)
        return jl.cross_entropy(lg, jnp.asarray(labels)) + jnp.sum(
            lg * probe) / s

    gf, gw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(feats),
                                                jnp.asarray(weight))
    f, w = T(feats).requires_grad_(), T(weight).requires_grad_()
    lg = tl.arcface_logits(f, w, T(labels), s=s, m=m)
    (tl.cross_entropy(lg, T(labels)) + (lg * T(probe)).sum() / s).backward()
    _close(f.grad, gf, 1e-5, "d/dfeatures")
    _close(w.grad, gw, 1e-5, "d/dweight")


# -- BatchNorm in train mode ----------------------------------------------------

@pytest.mark.parametrize("module", ["port", "stock"])
def test_train_batchnorm_matches_flax(module):
    """layer4 at 32 px, batch 4: [4, 1, 1, 512], n = 4 per channel."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((4, 1, 1, 512)).astype(np.float32) * 2 + 0.5
          for _ in range(3)]
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = fbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    bn = (BatchNorm if module == "port" else nn.BatchNorm2d)(512).train()
    errs = []
    for i, x in enumerate(xs):
        y_f, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **upd}
        y_t = bn(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        stats = variables["batch_stats"]
        errs.append(max(
            np.abs(y_t.detach().numpy() - np.asarray(y_f)).max(),
            np.abs(bn.running_mean.numpy() - np.asarray(stats["mean"])).max(),
            np.abs(bn.running_var.numpy() - np.asarray(stats["var"])).max()))
        if module == "port" and i in (0, 2):  # after one and three steps
            assert errs[-1] <= 1e-5, (i, errs[-1])
    if module == "stock":  # torch's unbiased running variance: caught
        assert max(errs) > 1e-2, errs


# -- schedule -------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (1, 1e-6, 100, 0.01, 1e-6, 37),   # gem_r50's defaults, 37 updates/epoch
    (1, 1e-6, 6, 1e-3, 1e-5, 46),     # the rigorous synthetic run
    (1, 1e-6, 3, 0.01, 1e-6, 1),      # one warmup update (warmup_iters <= 1)
    (0, 1e-3, 4, 1e-2, 1e-6, 5),      # no warmup (the SGD phase of a hand-off)
])
def test_schedule_matches_jax(args):
    """Every step.  The JAX schedule computes in float32 and so does the
    port, operation for operation; XLA's float32 cos is not correctly
    rounded (1 ulp off the rounded float64 cos on ~1% of arguments), and
    near the end of the decay, where 1 + cos cancels, that ulp is up to
    2e-7 of the lr itself.  So the bar is 1e-7 relative to the larger of
    the lr and the schedule's peak ``base_lr``."""
    j, t = jax_schedule(*args), warmup_cosine_schedule(*args)
    n = args[-1] * args[2] + 3
    js = np.array([float(j(s)) for s in range(n)])
    ts = np.array([t(s) for s in range(n)])
    err = np.abs(ts - js) / np.maximum(np.abs(js), args[3])
    assert err.max() <= 1e-7, err.max()


# -- optimizers -------------------------------------------------------------------

class _Tree(nn.Module):
    def __init__(self, leaves):
        super().__init__()
        for k, v in leaves.items():
            setattr(self, k, nn.Parameter(T(v.copy())))


@pytest.mark.parametrize("kind, clip, every", [
    ("sgd", 0.0, 1), ("sgd", 0.5, 1), ("sgd", 100.0, 1), ("sgd", 0.5, 2),
    ("adamw", 0.0, 1), ("adamw", 0.5, 1), ("adamw", 0.5, 2)])
def test_optimizer_matches_optax(kind, clip, every):
    rng = np.random.default_rng(4)
    leaves = {"a": rng.standard_normal(7), "b": rng.standard_normal((3, 5)),
              "c": rng.standard_normal((2, 3, 3, 4))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    grads = [{k: (rng.standard_normal(v.shape) * 0.7).astype(np.float32)
              for k, v in leaves.items()} for _ in range(5)]
    sched = jax_schedule(1, 1e-3, 4, 0.05, 1e-4, 2)
    if kind == "sgd":
        jtx = jopt.make_sgd_optimizer(sched, weight_decay=0.01,
                                      clip_max_norm=clip, update_every=every)
        ttx = make_sgd_optimizer(warmup_cosine_schedule(1, 1e-3, 4, 0.05, 1e-4,
                                                        2),
                                 weight_decay=0.01, clip_max_norm=clip,
                                 update_every=every)
    else:
        jtx = jopt.make_adamw_optimizer(sched, weight_decay=0.05,
                                        clip_max_norm=clip,
                                        update_every=every)
        ttx = make_adamw_optimizer(warmup_cosine_schedule(1, 1e-3, 4, 0.05,
                                                          1e-4, 2),
                                   weight_decay=0.05, clip_max_norm=clip,
                                   update_every=every)
    params = {k: jnp.asarray(v) for k, v in leaves.items()}
    jstate = jtx.init(params)
    tree = _Tree(leaves)
    opt = ttx.init(tree)
    norms = []
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, params)
        params = optax.apply_updates(params, upd)
        for k, p in tree.named_parameters():
            p.grad = T(g[k].copy())
        norms.append(float(opt.step()))
        for k, p in tree.named_parameters():  # fp32 leaves of O(1)
            np.testing.assert_allclose(p.detach().numpy(), params[k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    want = [float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
            for g in grads]
    _close(norms, want, 1e-6, "raw grad norm")
    if clip == 0.5:
        assert min(want) > 0.5  # the clip was active
    if clip == 100.0:
        assert max(want) < 100.0  # below the norm: no clip


def test_weight_decay_mask_and_state_dict():
    tree = _Tree({"a": np.ones(3, np.float32), "b": np.ones((2, 2), np.float32)})
    opt = make_sgd_optimizer(0.1, weight_decay=0.5).init(tree)
    groups = opt.inner.param_groups
    assert [g["weight_decay"] for g in groups] == [0.5, 0.0]
    assert groups[0]["params"][0] is tree.b and groups[1]["params"][0] is tree.a
    assert groups[0]["nesterov"] and groups[0]["dampening"] == 0.0
    adam = make_adamw_optimizer(0.1).init(_Tree({"a": np.ones(3, np.float32),
                                                 "b": np.ones((2, 2),
                                                              np.float32)}))
    with pytest.raises(ValueError, match="kind"):
        adam.load_state_dict(opt.state_dict())


# -- one train step against JAX make_train_step ------------------------------------

def _uint8_batches(n, B=4, px=32, classes=8, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (B, px, px, 3), dtype=np.uint8),
             rng.integers(0, classes, B)) for _ in range(n)]


ULP = 2.0 ** -23


def _leaf_devs(got: dict, want: dict) -> dict:
    """Per key: max |got - want| over the largest |want| of the leaf."""
    return {k: float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}


def _as_port(params, stats):
    return {k: v.numpy().astype(np.float64) for k, v in from_jax_variables(
        {"params": params, "batch_stats": stats}).items()}


@pytest.fixture(scope="module")
def step_pair():
    """Three SGD steps (nesterov, masked decay, clip 1.0, cosine decay
    from 5e-3) of JAX ``make_train_step`` and of the port's from one JAX
    init; two more JAX runs with every input scaled by (1 +- 2^-23), one
    ulp; and JAX's metrics of the init on each batch (what a step that
    skipped its update would report).  The one-ulp runs measure the
    float32 floor of this configuration (train-mode BN over 4 values per
    channel at layer4 amplifies rounding): the bars below are the stated
    ones or 10x JAX's own deviation under those one-ulp changes,
    whichever is larger.  That floor is ~1.4e-4 of a leaf's max for the
    gradients at init, and ~9e-5 / 1.7e-4 of a leaf's largest change
    after 1 / 3 steps.  It is heavy-tailed in the learning rate: at 0.05
    one of the two runs moves a leaf by 6e-2 of its change in 3 steps."""
    jm = jax_get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                       num_classes=8)
    batches = _uint8_batches(3)
    prep = jloop.fused_input_norm(NORM)
    xs = [np.asarray(prep(jnp.asarray(x))) for x, _ in batches]
    sched = (0, 5e-3, 3, 5e-3, 5e-4, 2)  # cosine from 5e-3 over 6 steps
    jtx = jopt.make_sgd_optimizer(jax_schedule(*sched), weight_decay=1e-4,
                                  clip_max_norm=1.0)
    jinit = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                     jnp.asarray(xs[0]),
                                     jnp.asarray(batches[0][1]), jtx)
    ttx = make_sgd_optimizer(warmup_cosine_schedule(*sched),
                             weight_decay=1e-4, clip_max_norm=1.0)
    tstate = create_train_state(
        get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                  num_classes=8), 0, ttx, device="cpu")
    tstate.model.load_state_dict(from_jax_variables(
        {"params": jinit.params, "batch_stats": jinit.batch_stats}))
    init_port = copy.deepcopy(tstate.model)
    # the port step normalizes uint8 on the device; JAX takes the same
    # normalized floats (its fused stage gives them bit for bit)
    jstep = jloop.make_train_step(jm, jtx, donate=False)
    tstep = make_train_step(NORM)
    steps, ref, bumps = [], jinit, [jinit, jinit]
    for (x, y), xf in zip(batches, xs):
        _, still = jstep(jinit, jnp.asarray(xf), jnp.asarray(y))
        ref, jmet = jstep(ref, jnp.asarray(xf), jnp.asarray(y))
        bumped = [jstep(b, jnp.asarray(xf * (1 + d * ULP)), jnp.asarray(y))
                  for b, d in zip(bumps, (1, -1))]
        bumps = [b for b, _ in bumped]
        tstate, tmet = tstep(tstate, x, y)
        steps.append(dict(
            jax=ref, jmet=jmet, bmets=[m for _, m in bumped], tmet=tmet,
            still=still,
            want=_as_port(ref.params, ref.batch_stats),
            floors=[_as_port(b.params, b.batch_stats) for b in bumps],
            port={k: v.detach().clone().numpy() for k, v in
                  tstate.model.state_dict().items()}))

    @jax.jit
    def grads(params, stats, x, y):
        def loss_fn(p):
            (loss, _), _ = jm.apply({"params": p, "batch_stats": stats}, x,
                                    labels=y, train=True,
                                    mutable=["batch_stats"])
            return loss
        return jax.grad(loss_fn)(params)

    return dict(jm=jm, jinit=jinit, init_port=init_port, steps=steps,
                init=_as_port(jinit.params, jinit.batch_stats),
                batches=batches, xs=xs, tstate=tstate, grads=grads)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def test_train_step_metrics_match_jax(step_pair):
    """Step 1 starts both sides from one state: loss to 1e-5 and
    grad_norm to 1e-4, relative.  Steps 2 and 3 start from states that
    have drifted apart by the float32 floor, so the bars there are the
    same or 10x JAX's own deviation of that metric when the inputs move
    by one ulp, if larger; and there the updates must have moved each
    metric by more than its bar (the JAX init's metrics on the same batch
    miss it), so a step that skipped its update fails."""
    for i, s in enumerate(step_pair["steps"]):
        j, t = s["jmet"], s["tmet"]
        for key, bar in (("loss", 1e-5), ("grad_norm", 1e-4)):
            if i:
                bar = max(bar, 10 * max(_rel(b[key], j[key])
                                        for b in s["bmets"]))
                assert _rel(s["still"][key], j[key]) > bar, (i, key, bar)
            assert _rel(t[key], j[key]) <= bar, (i, key, bar)
        assert float(t["top1_err"]) == float(j["top1_err"])
        assert float(t["top5_err"]) == float(j["top5_err"])
    assert float(step_pair["steps"][0]["jmet"]["grad_norm"]) > 1.0  # clipped
    assert step_pair["tstate"].step == 3
    assert step_pair["tstate"].optimizer.count == 3


def _change_devs(state: dict, want: dict, init: dict) -> dict:
    """Per key: how far ``state - init`` is from ``want - init`` beyond two
    float32 spacings at each element of ``want`` (a stored parameter
    resolves no finer change), over the leaf's largest ``|want - init|``."""
    out = {}
    for k in init:
        w = np.asarray(want[k], np.float64) - init[k]
        miss = np.abs(np.asarray(state[k], np.float64) - init[k] - w) \
            - 2 * np.spacing(np.abs(want[k]).astype(np.float32))
        out[k] = float(np.clip(miss, 0, None).max()
                       / max(np.abs(w).max(), 1e-30))
    return out


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_params_and_stats_match_jax(step_pair, after):
    """What the steps moved (the state minus the shared JAX init) against
    what JAX's moved, each leaf relative to its largest change, beyond
    what float32 storage resolves (``_change_devs``): 1e-4, or 10x JAX's
    own deviation when the inputs move by one ulp where that is larger.
    A step that skipped or mis-scaled its update is off by the whole
    change (1.0).  The BN statistics themselves to 1e-4."""
    s, init = step_pair["steps"][after - 1], step_pair["init"]
    floor = max(max(_change_devs(f, s["want"], init).values())
                for f in s["floors"])
    devs = _change_devs(s["port"], s["want"], init)
    bar = max(1e-4, 10 * floor)
    worst = max(devs, key=devs.get)
    assert bar < 0.1  # far below a skipped update's 1.0
    assert devs[worst] <= bar, (worst, devs[worst], floor)
    stats = {k: v for k, v in _leaf_devs(s["port"], s["want"]).items()
             if "running" in k}
    assert max(stats.values()) <= 1e-4, max(stats, key=stats.get)


@pytest.mark.parametrize("at", ["init", "step3"])
def test_train_gradients_match_jax(step_pair, at):
    """Gradients of one loss at one state (the JAX init, or JAX's state
    after 3 steps loaded into the port): the port's autograd against
    ``jax.grad``."""
    if at == "init":
        jstate, port = step_pair["jinit"], step_pair["init_port"]
    else:
        jstate = step_pair["steps"][-1]["jax"]
        port = get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                         num_classes=8)
        port.load_state_dict(from_jax_variables(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    (x, y), xf = step_pair["batches"][0], step_pair["xs"][0]

    def jgrads(scale):
        g = step_pair["grads"](jstate.params, jstate.batch_stats,
                               jnp.asarray(xf * scale), jnp.asarray(y))
        return _as_port(g, jstate.batch_stats)

    want, bumped = jgrads(1.0), jgrads(1 + ULP)
    m = copy.deepcopy(port).train()
    loss, _ = m((T(x).float() / 255.0 - T(IMAGENET_MEAN)) / T(IMAGENET_STD),
                T(y))
    loss.backward()
    got = {n: p.grad.numpy() for n, p in m.named_parameters()}
    want = {k: want[k] for k in got}
    floor = max(_leaf_devs(bumped, want).values())
    devs = _leaf_devs(got, want)
    worst = max(devs, key=devs.get)
    assert devs[worst] <= max(1e-4, 10 * floor), (worst, devs[worst], floor)


def test_eval_step_matches_jax(step_pair):
    s = step_pair["steps"][-1]
    x, y = step_pair["batches"][1]
    jev = jloop.make_eval_step(step_pair["jm"], input_norm=NORM)
    j = jev(s["jax"], jnp.asarray(x), jnp.asarray(y))
    state = create_train_state(
        get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                  num_classes=8), 0, make_sgd_optimizer(0.1), "cpu")
    state.model.load_state_dict(from_jax_variables(
        {"params": s["jax"].params, "batch_stats": s["jax"].batch_stats}))
    t = make_eval_step(NORM)(state, x, y)
    assert float(t["loss"]) == pytest.approx(float(j["loss"]), rel=1e-5)
    assert float(t["top1_err"]) == float(j["top1_err"])


# -- training init -----------------------------------------------------------------

def test_training_init_law_and_shapes():
    jm = jax_get_model("gem_r50", backbone_name="resnet18", outputdim=64,
                       num_classes=300)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         dict(shapes))
    want = from_jax_variables(zeros)
    port = get_model("gem_r50", backbone_name="resnet18", outputdim=64,
                     num_classes=300)
    training_init(port, torch.Generator().manual_seed(0))
    sd = port.state_dict()
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert set(k for k in sd if "num_batches" not in k) == set(want)
    for name, mod in port.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight.detach()
            std = math.sqrt(1.0 / w[0].numel())  # lecun_normal's law
            assert abs(w.std().item() / std - 1) < 0.05, name
            assert w.abs().max().item() <= 2 * std / 0.8796 + 1e-6, name
            if mod.bias is not None:
                assert not mod.bias.any(), name
        elif isinstance(mod, nn.BatchNorm2d):
            assert (mod.weight == 1).all() and not mod.bias.any()
            assert not mod.running_mean.any() and (mod.running_var == 1).all()
    limit = math.sqrt(6.0 / (300 + 64))  # xavier-uniform
    cw = port.classifier_w.detach()
    assert cw.abs().max().item() <= limit
    assert abs(cw.std().item() / (limit / math.sqrt(3)) - 1) < 0.05


# -- checkpoints -------------------------------------------------------------------

def test_checkpoint_retention_and_roundtrip(tmp_path):
    model = get_model("gem_r50", backbone_name="resnet18", outputdim=8,
                      num_classes=4)
    state = create_train_state(model, 0, make_sgd_optimizer(0.1), "cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_every=5, keep_last=1)
    for epoch in range(1, 8):
        mgr.save(epoch, state.state_dict(), metric=10.0 - epoch)
    kept = mgr._list_epochs()
    assert kept == [5, 7]  # every 5th, plus the most recent (the JAX rule)
    assert mgr.latest_epoch() == 7
    payload, ep = mgr.restore()
    assert ep == 7 and payload["step"] == 0
    for k, v in model.state_dict().items():
        assert torch.equal(payload["model"][k], v), k
    best, ep = mgr.restore(best=True)
    assert ep == -1 and set(best) == set(payload)
    mgr2 = CheckpointManager(str(tmp_path / "ck2"), keep_every=5,
                             keep_last=1)
    mgr2.save(1, {"x": 1}, metric=2.0)
    mgr2.save(2, {"x": 2}, metric=3.0)  # worse: best stays epoch 1's
    assert mgr2.restore(best=True)[0] == {"x": 1}


def test_partial_load_torchvision_backbone():
    src = get_model("gem_r50", backbone_name="resnet18", outputdim=8,
                    num_classes=4).backbone
    training_init(src, torch.Generator().manual_seed(1))
    tv = {**src.state_dict(), "fc.weight": torch.zeros(1000, 512),
          "fc.bias": torch.zeros(1000)}
    model = get_model("gem_r50", backbone_name="resnet18", outputdim=8,
                      num_classes=4)
    before = model.whiten.weight.detach().clone()
    report = partial_load(model, tv, rename={"": "backbone."})
    assert "backbone.fc.weight" in report["unmatched_source"]
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[f"backbone.{k}"], v), k
    assert torch.equal(model.whiten.weight, before)
    assert "whiten.weight" in report["kept_target"]
    bigger = {"classifier_w": torch.zeros(9, 8)}
    assert partial_load(model, bigger)["shape_mismatch"] == ["classifier_w"]
