"""PyTorch port, the training utilities on the CPU against the JAX
package:

* ``plot_curves`` / ``plot_from_jsonl`` write PNGs; the driver draws
  ``curves.png`` every ``plot_freq`` epochs and, where matplotlib does
  not import, says so once and trains on;
* ``freeze_mask`` / ``freeze_all_but`` over the port's parameter names
  equal JAX's masks over the flax tree (converted leaf by leaf with
  ``from_jax_variables``, which maps flax ``layer1_0`` to ``layer1.0``,
  ``kernel`` / ``scale`` to ``weight``);
* ``apply_freeze`` over SGD-nesterov and AdamW (masked decay, clip 1.0):
  two updates from the same seeded gradients, frozen leaves bit-equal to
  their start, the others' changes equal to ``optax.multi_transform``'s
  at 1e-5 of each leaf's largest change beyond two float32 spacings
  (``_change_devs``), ``grad_norm`` over every gradient as in the JAX
  step;
* ``DistractorDataset`` / ``partition_for_host`` equal JAX's on the same
  source (thumbnails within the one grey level the port's Lanczos-4
  differs by, ``tests/test_torch_cli.py``).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.data import distractor as jdistractor
from research_image_retrieval_tpu.train import freeze as jfreeze
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu_torch.data import distractor as tdistractor
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.train import driver as drv
from research_image_retrieval_tpu_torch.train import freeze as tfreeze
from research_image_retrieval_tpu_torch.train import plots as tplots
from research_image_retrieval_tpu_torch.train.optimizer import (
    make_adamw_optimizer,
    make_sgd_optimizer,
)
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import _change_devs
from test_torch_train_cli import _tiny_cfg

PNG = b"\x89PNG\r\n\x1a\n"
SMALL = dict(backbone_name="resnet18", outputdim=32, distill_dim=16,
             text_dim=48, num_classes=8)


def test_plot_curves_and_jsonl(tmp_path):
    out = tplots.plot_curves({"train_loss": [3.0, 2.5, 2.2],
                              "val_top1_err": [90.0, 80.0],
                              "preempted": False, "empty": []},
                             str(tmp_path / "a" / "c.png"), title="t")
    assert open(out, "rb").read(8) == PNG
    log = tmp_path / "m.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in (
        {"step": 1, "train_loss": 2.0, "note": "x"},
        {"step": 2, "train_loss": 1.5, "lr": 0.1})))
    out = tplots.plot_from_jsonl(str(log), str(tmp_path / "j.png"))
    assert open(out, "rb").read(8) == PNG


def test_driver_draws_curves_or_says_why(tmp_path, monkeypatch, capsys):
    """``plot_freq=1``: ``curves.png`` after the first epoch.  With
    matplotlib's import failing, the driver prints why once (JAX's
    message) and finishes the run."""
    drv.train(_tiny_cfg(tmp_path / "a", plot_freq=1, num_epochs=1))
    assert open(tmp_path / "a" / "curves.png", "rb").read(8) == PNG
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    state, hist = drv.train(_tiny_cfg(tmp_path / "b", plot_freq=1))
    out = capsys.readouterr().out
    assert out.count(">> curve plotting unavailable: No module named "
                     "'matplotlib'") == 1
    assert len(hist["train_loss"]) == 2
    assert not os.path.exists(tmp_path / "b" / "curves.png")


@functools.cache
def _flax_sparse():
    """A small sparse_r50's flax variables (jitted init), numpy; callers
    do not modify them."""
    jm = jmodels.get_model("sparse_r50", **SMALL)
    return jax.tree_util.tree_map(np.asarray, jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))())


def _as_port_names(tree, stats):
    """A flax-layout tree of per-leaf values -> ``{port name: array}``
    (parameters only)."""
    sd = from_jax_variables({"params": tree, "batch_stats": stats})
    return {k: v.numpy() for k, v in sd.items() if "running" not in k}


MASKS = [("freeze", ["backbone"]), ("freeze", ["distill", "quant"]),
         ("keep", ["bn1", "bn2", "bn3"]), ("keep", ["classifier", "ln"])]


@pytest.mark.parametrize("kind, names", MASKS,
                         ids=[f"{k}-{'+'.join(n)}" for k, n in MASKS])
def test_freeze_masks_match_jax(kind, names):
    v = _flax_sparse()
    jfn = jfreeze.freeze_mask if kind == "freeze" else jfreeze.freeze_all_but
    tfn = tfreeze.freeze_mask if kind == "freeze" else tfreeze.freeze_all_but
    jmask = jfn(v["params"], names)
    want = _as_port_names(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), jmask,
        v["params"]), v["batch_stats"])
    model = get_model("sparse_r50", **SMALL)
    got = tfn(model, names)
    assert set(got) == set(want)
    for k, m in got.items():
        assert np.all(want[k] == float(m)), k
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_apply_freeze_matches_optax(kind):
    """Two updates of a small sparse_r50 with the backbone and the
    quantizer frozen, from the same seeded gradients (large enough that
    clip 1.0 applies, over the trainable leaves only, as
    ``multi_transform`` clips inside its "train" branch)."""
    v = _flax_sparse()
    params = v["params"]
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(2)]
    frozen = ["backbone", "quant"]
    if kind == "sgd":
        jtx = jopt.make_sgd_optimizer(0.1, weight_decay=1e-2,
                                      clip_max_norm=1.0)
        ttx = make_sgd_optimizer(0.1, weight_decay=1e-2, clip_max_norm=1.0)
    else:
        jtx = jopt.make_adamw_optimizer(1e-2, weight_decay=0.05,
                                        clip_max_norm=1.0)
        ttx = make_adamw_optimizer(1e-2, weight_decay=0.05,
                                   clip_max_norm=1.0)
    jtx = jfreeze.apply_freeze(jtx, lambda p: jfreeze.freeze_mask(p, frozen))
    ttx = tfreeze.apply_freeze(ttx, lambda m: tfreeze.freeze_mask(m, frozen))

    @jax.jit
    def run(params, g1, g2):
        state = jtx.init(params)
        for g in (g1, g2):
            upd, state = jtx.update(g, state, params)
            params = optax.apply_updates(params, upd)
        return params

    want = _as_port_names(run(params, *grads), v["batch_stats"])
    model = get_model("sparse_r50", **SMALL)
    model.load_state_dict(from_jax_variables(v))
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = ttx.init(model)
    for g in grads:
        tg = _as_port_names(g, v["batch_stats"])
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(tg[k].copy())
        norm = opt.step()
        assert float(norm) == pytest.approx(float(optax.global_norm(g)),
                                            rel=1e-6)
    mask = tfreeze.freeze_mask(model, frozen)
    init = _as_port_names(params, v["batch_stats"])
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    devs = _change_devs(got, want, init)
    for k, p in model.named_parameters():
        if not mask[k]:
            assert torch.equal(p.detach(), start[k]), k
            np.testing.assert_array_equal(want[k], init[k], err_msg=k)
        else:
            assert np.abs(want[k] - init[k]).max() > 0, k
            assert devs[k] <= 1e-5, (k, devs[k])


def test_distractor_matches_jax():
    rng = np.random.default_rng(2)
    source = [(rng.integers(0, 256, (20 + 3 * i, 30, 3), dtype=np.uint8), i)
              for i in range(7)]
    source[3] = source[3][0]  # a bare image
    for n in (0, 1, 7, 10):
        assert [tdistractor.partition_for_host(n, h, 3) for h in range(3)] \
            == [jdistractor.partition_for_host(n, h, 3) for h in range(3)]
    kwargs = [dict(), dict(pool=[6, 1, 3, 5]), dict(partition=(2, 5)),
              dict(pool=[0, 2, 3, 4, 6], partition=(1, 3), imsize=16),
              dict(imsize=24, transform=lambda im: im[::2])]
    for kw in kwargs:
        got = tdistractor.DistractorDataset(source, **kw)
        want = jdistractor.DistractorDataset(source, **kw)
        assert len(got) == len(want) and got.pool == want.pool
        for g, w in zip(got, want):
            assert g.shape == w.shape
            tol = 1 if "imsize" in kw else 0
            assert np.abs(g.astype(int) - w.astype(int)).max() <= tol, kw
