"""PyTorch port, the CVNet reranker on the CPU against the JAX package,
on JAX's own ``PRNGKey(0)`` init converted by ``from_jax_variables``
(a resnet18 encoder, ``reduction_dim`` 16, as ``tests/test_rerank.py``):

* ``CenterPivotConv4d`` at each (kernel, stride) of ``CVLearner``, on
  odd and even planes of unequal query and key sizes (flax's ``SAME``
  pads a stride-2 plane asymmetrically), flax's ``GroupNorm`` of a 6-D
  tensor, ``build_correlation`` (the antialiased pyramid, the 9 clamped
  volumes upscaled over four axes), ``CVLearner`` and
  ``score_from_featuremaps``, each to 1e-5;
* ``extract_featuremap`` and ``extract`` (masked) to 1e-4;
* ``make_cvnet_batch_scorer`` with a padded tail chunk: equal to
  per-pair scoring and to JAX's scorer;
* ``cli.evaluate --cvnet-rerank --host-scales`` against the JAX driver
  on the on-disk Revisited fixture of ``tests/test_eval_driver.py``:
  equal ranks after the rerank and equal E/M/H mAP, JAX's init passed as
  ``--rerank-checkpoint`` (host scales: with device scales the JAX
  driver feeds the reranker un-normalized 0-255 images, which the port
  does not copy);
* a ``.pt`` checkpoint of another shape loads only its matching arrays.
"""

import dataclasses
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from research_image_retrieval_tpu.evaluation import driver as jdriver
from research_image_retrieval_tpu.index import rerank as jrerank
from research_image_retrieval_tpu.models import cvnet as jcvnet
from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.utils.config import EvalConfig as JaxCfg
from research_image_retrieval_tpu_torch.cli import evaluate as cli_evaluate
from research_image_retrieval_tpu_torch.evaluation import driver as tdriver
from research_image_retrieval_tpu_torch.index import (
    make_cvnet_batch_scorer,
    rerank_shortlist,
    rerank_shortlist_batched,
)
from research_image_retrieval_tpu_torch.models import (
    MODEL_REGISTRY,
    CenterPivotConv4d,
    CVLearner,
    CVNetRerank,
    from_jax_variables,
)
from research_image_retrieval_tpu_torch.models import cvnet as tcvnet
from research_image_retrieval_tpu_torch.models.backbone import same_pads
from research_image_retrieval_tpu_torch.utils.config import EvalConfig
from test_eval_driver import revisited_dir  # noqa: F401
from test_torch_bf16 import _fill_variables
from test_torch_cli import jnp_to_np
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
SMALL = dict(backbone_name="resnet18", reduction_dim=16)


def _port(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


def _close(got, want, atol):
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=0)


@functools.cache
def cvnet(px=64):
    """(JAX ``CVNetRerank``, its ``PRNGKey(0)`` variables as numpy, the
    port's model loaded from them)."""
    jm = jcvnet.CVNetRerank(**SMALL)
    probe = jnp.zeros((1, px, px, 3))
    variables = jnp_to_np(jax.jit(jm.init)(jax.random.PRNGKey(0), probe,
                                           probe))
    return jm, variables, _port(CVNetRerank(**SMALL), variables)


@pytest.mark.parametrize("spec", [(16, 5, 2, 2), (16, 3, 1, 1),
                                  (32, 3, 2, 2)],
                         ids=["k5s2", "k3s1", "k3s2"])
def test_center_pivot_conv4d_matches_jax(spec):
    """[2, 7, 6, 5, 4, 8] in: odd and even planes, query and key of
    different sizes; seeded weights and bias."""
    feats, k, qs, ks = spec
    jm = jcvnet.CenterPivotConv4d(feats, k, qs, ks)
    x = np.random.default_rng(0).standard_normal(
        (2, 7, 6, 5, 4, 8)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    variables = _fill_variables(shapes, 1)
    want = jax.jit(jm.apply)(variables, x)
    port = _port(CenterPivotConv4d(8, feats, k, qs, ks), variables)
    got = port(T(x))
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_same_pads_are_flax_s():
    assert same_pads(14, 5, 2) == (1, 2)
    assert same_pads(8, 3, 2) == (0, 1)
    assert same_pads(7, 3, 2) == (1, 1)
    assert same_pads(7, 3, 1) == (1, 1)


def test_group_norm_matches_flax():
    """flax ``GroupNorm(4)`` of a [2, 3, 3, 2, 2, 16] tensor of variance
    ~1e-5, where eps 1e-6 (torch's default is 1e-5) shows."""
    rng = np.random.default_rng(2)
    x = (3e-3 * rng.standard_normal((2, 3, 3, 2, 2, 16))).astype(
        np.float32)
    jm = fnn.GroupNorm(num_groups=4)
    variables = _fill_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x)), 3)
    want = jax.jit(jm.apply)(variables, x)
    port = tcvnet.GroupNorm(16, 4)
    port.load_state_dict({"weight": T(variables["params"]["scale"]),
                          "bias": T(variables["params"]["bias"])})
    _close(port(T(x)), want, 1e-5)


def _fmaps(seed, shape):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def test_correlation_learner_and_score_match_jax():
    """``build_correlation`` of a 14 x 14 query map (the default 224 px
    rerank's geometry: pyramid 3, 7, 14) and a 9 x 11 key map, then
    ``CVLearner`` on it and ``score_from_featuremaps`` of 14 x 14 pairs."""
    jm, variables, port = cvnet()
    q, k = _fmaps(0, (2, 14, 14, 256)), _fmaps(1, (2, 9, 11, 256))
    corr = jax.jit(functools.partial(jm.apply, method="build_correlation"))(
        variables, q, k)
    got = port.build_correlation(T(q), T(k))
    assert got.shape == (2, 14, 14, 9, 11, 9)
    _close(got, corr, 1e-5)
    learner = {"params": variables["params"]["cv_learner"]}
    want = jax.jit(jcvnet.CVLearner().apply)(learner, np.array(corr))
    _close(port.cv_learner(T(np.array(corr))), want, 1e-5)
    k2 = _fmaps(2, (2, 14, 14, 256))
    want = jax.jit(functools.partial(
        jm.apply, method="score_from_featuremaps"))(variables, q, k2)
    got = port.score_from_featuremaps(T(q), T(k2))
    _close(got, want, 1e-5)
    assert isinstance(port.cv_learner, CVLearner)


def test_featuremap_and_extract_match_jax():
    jm, variables, port = cvnet()
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    ext = np.array([[64, 40], [36, 64]], np.int32)
    x[1, 36:] = 0.0
    x[0, :, 40:] = 0.0
    fm = jax.jit(functools.partial(jm.apply, method="extract_featuremap"))
    ex = jax.jit(functools.partial(jm.apply, method="extract"))
    with torch.no_grad():
        _close(port.extract_featuremap(T(x)), fm(variables, x), 1e-4)
        _close(port.extract(T(x), T(ext)), ex(variables, x, ext), 1e-4)


def test_batch_scorer_pads_the_tail_chunk():
    """6 pairs in chunks of 4 (a tail of 2 padded to 4): the rerank equals
    per-pair scoring, and JAX's batched scorer on the same maps."""
    jm, variables, port = cvnet()
    qf, gf = _fmaps(5, (2, 4, 4, 256)), _fmaps(6, (5, 4, 4, 256))
    rng = np.random.default_rng(7)
    scores = -np.sort(-rng.uniform(0, 1, (2, 3)))
    indices = np.stack([rng.choice(5, 3, replace=False) for _ in range(2)])

    def per_pair(qi, gi):
        with torch.no_grad():
            return float(port.score_from_featuremaps(
                T(qf[qi:qi + 1]), T(gf[gi:gi + 1]))[0])

    calls = []
    scorer = make_cvnet_batch_scorer(port, qf, gf, chunk=4)
    real = port.score_from_featuremaps
    port.score_from_featuremaps = lambda a, b: calls.append(len(a)) or \
        real(a, b)
    try:
        got = rerank_shortlist_batched(scores, indices, scorer, blend=0.5)
    finally:
        del port.score_from_featuremaps
    assert calls == [4, 4]
    want = rerank_shortlist(scores, indices, per_pair, blend=0.5)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    jscorer = jrerank.make_cvnet_batch_scorer(jm, variables, qf, gf, chunk=4)
    qids, gids = np.repeat(np.arange(2), 3), indices.reshape(-1)
    np.testing.assert_allclose(scorer(qids, gids), jscorer(qids, gids),
                               rtol=0, atol=1e-5)


def test_load_cvnet_matches_shapes(tmp_path, capsys):
    """A ``.pt`` of another reduction width loads the encoder and the
    learner (same shapes) and leaves the three ``compress`` convs
    seeded; no checkpoint warns."""
    small = CVNetRerank(backbone_name="resnet18", reduction_dim=8)
    torch.save(small.state_dict(), tmp_path / "cv.pt")
    cfg = EvalConfig(rerank_backbone="resnet18",
                     rerank_checkpoint=str(tmp_path / "cv.pt"))
    model = tdriver.load_cvnet(cfg, "cpu")
    out = capsys.readouterr().out
    n = sum(1 for k in small.state_dict()
            if not k.endswith("num_batches_tracked"))
    assert f"{n - 3} arrays loaded, 3 shape-mismatched" in out
    assert torch.equal(model.encoder.conv1.weight, small.encoder.conv1.weight)
    assert not model.training
    tdriver.load_cvnet(EvalConfig(rerank_backbone="resnet18"), "cpu")
    assert "RANDOM init" in capsys.readouterr().out


class _SmallJaxCVNet(jcvnet.CVNetRerank):
    """JAX's reranker at ``reduction_dim`` 16, its ``init`` jitted (the
    same values as the driver's eager init, in a quarter of the time)."""

    reduction_dim: int = 16

    def init(self, *args, **kwargs):
        return jax.jit(super().init)(*args, **kwargs)


def _recording(module, monkeypatch, name, into):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        into.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_evaluate_cvnet_rerank_equals_jax(revisited_dir, tmp_path,  # noqa: F811
                                          monkeypatch, capsys):
    """The JAX driver and ``cli.evaluate --cvnet-rerank`` on the same
    seeded resnet18 gem_r50 (its flax variables passed to the port as an
    ``.npz``), 64 px, host scales, the default rerank (top 20 of the 12
    gallery images at 224 px: 36 pairs, three 16-pair chunks); the
    reranker a resnet18 CVNet at ``reduction_dim`` 16 on both sides
    (JAX's from its ``PRNGKey(0)`` init, which the port reads from
    ``--rerank-checkpoint``): equal ranks after the rerank, which moved
    some query's order, and equal E/M/H mAP."""
    overrides = dict(backbone_name="resnet18", num_classes=8, outputdim=32)
    jm = jax_get_model("gem_r50", **overrides)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    variables = _fill_variables(shapes, 5)
    monkeypatch.setattr(jdriver, "_load_model",
                        lambda cfg, num_classes=0: (jm, variables))
    gem = tmp_path / "gem.npz"
    np.savez(gem, **traverse_util.flatten_dict(jnp_to_np(variables), sep="/"))
    monkeypatch.setattr(jcvnet, "CVNetRerank", _SmallJaxCVNet)
    probe = jnp.zeros((1, 224, 224, 3))
    cv_vars = jnp_to_np(_SmallJaxCVNet(backbone_name="resnet18").init(
        jax.random.PRNGKey(0), probe, probe))
    cv = tmp_path / "cvnet.npz"
    np.savez(cv, **traverse_util.flatten_dict(cv_vars, sep="/"))
    # the CLI builds the driver's CVNetRerank from EvalConfig's
    # rerank_backbone (no flag): make it the small one
    monkeypatch.setattr(tdriver, "CVNetRerank",
                        lambda backbone_name: CVNetRerank(**SMALL))
    entry = MODEL_REGISTRY["gem_r50"]
    monkeypatch.setitem(MODEL_REGISTRY, "gem_r50", dataclasses.replace(
        entry, defaults={**entry.defaults, "backbone_name": "resnet18",
                         "outputdim": 32}))
    jranks, tranks, treranks = [], [], []
    _recording(jdriver, monkeypatch, "compute_map_and_print", jranks)
    _recording(tdriver, monkeypatch, "compute_map_and_print", tranks)
    _recording(tdriver, monkeypatch, "_cvnet_rerank_ranks", treranks)
    want = jdriver.evaluate(JaxCfg(
        model="gem_r50", model_overrides=overrides, datasets=("roxford5k",),
        data_root=revisited_dir, imsize=64, device_scales=False,
        cvnet_rerank=True, rerank_backbone="resnet18"))
    out = tmp_path / "res.json"
    assert cli_evaluate.main([
        "--model", "gem_r50", "--datasets", "roxford5k", "--data-root",
        revisited_dir, "--imsize", "64", "--host-scales", "--checkpoint",
        str(gem), "--cvnet-rerank", "--rerank-checkpoint", str(cv),
        "--device", "cpu", "--output", str(out)]) == 0
    n = len(traverse_util.flatten_dict(cv_vars))
    assert f"{n} arrays loaded, 0 shape-mismatched" in capsys.readouterr().out
    got = json.loads(out.read_text())["roxford5k"]
    np.testing.assert_array_equal(tranks[0][0][3], jranks[0][0][3])
    assert tuple(got) == tuple(want["roxford5k"])
    before, after = treranks[0][0][2], treranks[0][1]
    assert (before != after).any()  # the rerank reordered a shortlist
