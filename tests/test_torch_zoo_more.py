"""PyTorch port, the zoo's SpCa, SoSNet, SpoC, SENet-G2+ and
AdaptiveHybrid families on the CPU against the JAX package, on the same
seeded numpy variables (random BN statistics; SpCa's ``pi`` / ``cov``,
SENet's ``gem_p`` / ``g2_alpha`` kept positive; every ``Attention.proj``
nonzero so the attention counts) converted by ``from_jax_variables``:

* each family's ``extract`` at resnet18 (senet_g2 at ``layers=(1, 1, 1,
  1)``), unmasked and on a bucket with per-image extents, to 1e-4 on the
  L2 descriptors: spca (96 px, 3 x 3 layer4 cells), sosnet (64 px),
  spoc (128 px: 4 x 4 cells, and 4 x 4 in the bucket's 100 px sides, so
  the masked pyramid is region-exact), senet_g2 (64 px),
  adaptive_hybrid (96 px, one image 1 cell wide and one 1 cell high, so
  the degenerate regional branches run); spca's other fusers through
  the same ``extract`` on a given layer4 map (``fur`` builds ``cro``'s
  fuser, checked by class and output);
* ``models/layers`` (``Attention`` with a key mask, ``Mlp``,
  ``Encoder`` in eval and train mode, ``Decoder``), the flax LayerNorm
  and the token-axis BN, ``second_order_pool``, both pyramid pools (the
  participating regions), both distance encodings,
  ``contrastive_loss`` and ``QAFF`` to 1e-5 or tighter;
* ``HybridGallery`` against JAX's on the same model and QAFF variables
  (16 gallery images, 4 queries, top 5): ids equal where neighbouring
  scores differ by more than 1e-6, scores to 1e-5;
* the registry (Table-1 names, ``get_model_info``) and the five presets
  against JAX's;
* ``cli.extract --model spca_r101`` (the full model at 64 px, through
  the GeM head's plain version), ``cli.evaluate --model senet_g2_r50``
  from a ``.pt`` of the whole model (it has no ``backbone``), and the
  serving ``ImageExtractor`` on adaptive_hybrid_r50, on the CPU.

One SGD step per family and the dropout generator are held in
``tests/test_torch_zoo_more_train.py``.
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.index.gallery import (
    HybridGallery as JaxGallery,
)
from research_image_retrieval_tpu.models import adaptive_hybrid as jah
from research_image_retrieval_tpu.models import backbone as jbackbone
from research_image_retrieval_tpu.models import layers as jlayers
from research_image_retrieval_tpu.models import sosnet as jsosnet
from research_image_retrieval_tpu.models import spca as jspca
from research_image_retrieval_tpu.models import spoc as jspoc
from research_image_retrieval_tpu.utils import config as jconfig
from research_image_retrieval_tpu_torch import models as tmodels
from research_image_retrieval_tpu_torch.index import HybridGallery
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
    layers as tlayers,
    qaff_from_flax,
    seeded_init,
)
from research_image_retrieval_tpu_torch.models import sosnet as tsosnet
from research_image_retrieval_tpu_torch.models import spca as tspca
from research_image_retrieval_tpu_torch.models import spoc as tspoc
from research_image_retrieval_tpu_torch.models.convert import _heads_from_flax
from research_image_retrieval_tpu_torch.utils import config as tconfig
from test_eval_driver import revisited_dir  # noqa: F401
from test_torch_bf16 import _fill_variables
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
NEW = ("spca_r50", "sosnet_r50", "spoc_r50", "senet_g2_r50",
       "adaptive_hybrid_r50")
# (image side, [B, 2] extents of the masked bucket) per family
GEOMETRY = {
    "spca_r50": (96, [[96, 50], [40, 96]]),
    "sosnet_r50": (64, [[64, 30], [30, 48]]),
    "spoc_r50": (128, [[128, 100], [100, 128]]),
    "senet_g2_r50": (64, [[64, 30], [30, 48]]),
    "adaptive_hybrid_r50": (96, [[96, 96], [96, 20], [30, 96]]),
}


def overrides(name, **kw):
    """Small configurations: resnet18 (senet_g2 one block per stage), 8
    classes, narrow heads."""
    base = dict(num_classes=8, outputdim=32)
    if name == "senet_g2_r50":
        base["layers"] = (1, 1, 1, 1)
    else:
        base["backbone_name"] = "resnet18"
    if name == "spca_r50":
        base.update(mediumdim=512, outputdim=64)
    return {**base, **kw}


def fill(shapes, seed):
    """``_fill_variables`` with the parameters a log, a square root or a
    power reads kept positive."""
    v = _fill_variables(shapes, seed)
    rng = np.random.default_rng(seed + 100)

    def fix(tree):
        for k, a in tree.items():
            if isinstance(a, dict):
                fix(a)
            elif k in ("pi", "cov"):
                tree[k] = (np.abs(a) + 0.5).astype(np.float32)
            elif k == "gem_p":
                tree[k] = (3.0 + 0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32)
            elif k == "g2_alpha":
                tree[k] = (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32)

    fix(v["params"])
    return v


@functools.cache
def jax_model(name, **kw):
    """(JAX model, seeded variables) at the family's size, shared by the
    tests of both files."""
    jm = jmodels.get_model(name, **overrides(name, **kw))
    px = GEOMETRY[name][0]
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    return jm, fill(shapes, 0)


def port_model(name, variables, **kw):
    port = get_model(name, **overrides(name, **kw))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


def bucket(name, seed=1):
    """(images [B, px, px, 3] zero outside each extent, extents)."""
    px, ext = GEOMETRY[name]
    ext = np.array(ext, np.int32)
    x = np.random.default_rng(seed).standard_normal(
        (len(ext), px, px, 3)).astype(np.float32)
    for i, (h, w) in enumerate(ext):
        x[i, h:] = 0.0
        x[i, :, w:] = 0.0
    return x, ext


# -- whole-model extraction ---------------------------------------------------

def _extract_pair(jm, variables, port, x, ext,
                  interceptor=lambda f, args, kwargs, ctx: f(*args, **kwargs)):
    """JAX's and the port's ``extract`` of ``x``, unmasked and on the
    bucket's extents, checked to 1e-4; ``interceptor`` sees JAX's module
    calls (``flax.linen.intercept_methods``)."""

    @jax.jit
    def jext(x, e):
        with fnn.intercept_methods(interceptor):
            return (jm.apply(variables, x, method="extract"),
                    jm.apply(variables, x, e, method="extract"))

    want = [np.asarray(w) for w in jext(jnp.asarray(x), jnp.asarray(ext))]
    with torch.no_grad():
        got = [port.extract(T(x)).numpy(),
               port.extract(T(x), T(ext)).numpy()]
    for g, w, what in zip(got, want, ("extract", "masked")):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)
    assert np.abs(got[1] - got[0]).max() > 1e-3  # the masks mattered


@pytest.mark.parametrize("name", NEW, ids=[n.split("_r50")[0] for n in NEW])
def test_zoo_more_extract_matches_jax(name):
    jm, variables = jax_model(name)
    x, ext = bucket(name)
    _extract_pair(jm, variables, port_model(name, variables).eval(), x, ext)


class _FixedMap(torch.nn.Module):
    def __init__(self, fmap):
        super().__init__()
        self.fmap = fmap

    def forward(self, x, valid_hw=None):
        return self.fmap


@pytest.mark.parametrize("combine", ["cat", "had", "orth", "dec"])
def test_spca_fusers_match_jax(combine):
    """SpCa's other fusers (``cro`` runs in the whole-model test) through
    each side's own ``extract`` with the backbone's layer4 map given: a
    seeded nonnegative [2, 3, 3, 512] map, unmasked and on the 96 px
    bucket's extents."""
    jm, variables = jax_model("spca_r50", combine=combine)
    port = port_model("spca_r50", variables, combine=combine).eval()
    x, ext = bucket("spca_r50")
    fmap = np.abs(np.random.default_rng(2).standard_normal(
        (len(ext), 3, 3, 512))).astype(np.float32)
    port.backbone = _FixedMap(T(fmap))

    def backbone_gives_fmap(f, args, kwargs, ctx):
        if isinstance(ctx.module, jbackbone.ResNet) and \
                ctx.method_name == "__call__":
            return jnp.asarray(fmap)
        return f(*args, **kwargs)

    _extract_pair(jm, variables, port, x, ext, backbone_gives_fmap)


def test_spca_fur_is_the_cross_attention_fuser():
    """``fur`` builds the ``cro`` fuser (the reference's ``Fuser_`` has
    ``Fuser``'s layers), as in JAX: the same class, keys and output."""
    kw = overrides("spca_r50")
    cro, fur = (get_model("spca_r50", combine=c, **kw).eval()
                for c in ("cro", "fur"))
    assert type(fur.fuser) is type(cro.fuser) is tspca.CrossAttnFuser
    fur.load_state_dict(cro.state_dict(), strict=True)
    x = T(bucket("spca_r50")[0])
    with torch.no_grad():
        assert torch.equal(fur.extract(x), cro.extract(x))


# -- layers -------------------------------------------------------------------

def _module_pair(jmod, port, args, seed, **apply_kw):
    """Seeded flax variables of ``jmod`` loaded into ``port``; returns
    (variables, missing keys)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              *args, **apply_kw))
    variables = _fill_variables(shapes, seed)
    sd = {}
    _heads_from_flax(variables["params"], variables.get("batch_stats", {}),
                     "", sd)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return variables


@pytest.mark.parametrize("which", ["attention", "mlp", "encoder-eval",
                                   "encoder-train", "decoder"])
def test_layers_match_jax(which):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 16)).astype(np.float32)
    key_mask = np.ones((2, 7), np.float32)
    key_mask[1, 4:] = 0.0  # the second row's last 3 keys are padding
    jq, jkv, jm = map(jnp.asarray, (q, kv, key_mask))
    if which == "attention":
        jmod = jlayers.Attention(16, 4, qkv_bias=True)
        port = tlayers.Attention(16, 4, qkv_bias=True)
        v = _module_pair(jmod, port, (jq, jkv, jkv), 1)
        want = jax.jit(lambda *a: jmod.apply(v, *a, key_mask=jm))(
            jq, jkv, jkv)
        got = port(T(q), T(kv), T(kv), key_mask=T(key_mask))
    elif which == "mlp":
        jmod, port = jlayers.Mlp(24, 8), tlayers.Mlp(16, 24, 8)
        v = _module_pair(jmod, port, (jq,), 2)
        want, got = jax.jit(lambda a: jmod.apply(v, a))(jq), port(T(q))
    elif which.startswith("encoder"):
        train = which.endswith("train")
        jmod, port = jlayers.Encoder(16, 4), tlayers.Encoder(16, 4)
        v = _module_pair(jmod, port, (jkv,), 3)
        port.train(train)
        if train:
            want, upd = jax.jit(lambda a: jmod.apply(
                v, a, train=True, key_mask=jm, mutable=["batch_stats"]))(jkv)
            stats = upd["batch_stats"]["bn"]
        else:
            want = jax.jit(lambda a: jmod.apply(v, a, key_mask=jm))(jkv)
        got = port(T(kv), key_mask=T(key_mask))
        if train:
            np.testing.assert_allclose(port.bn.running_mean.numpy(),
                                       stats["mean"], atol=1e-6)
            np.testing.assert_allclose(port.bn.running_var.numpy(),
                                       stats["var"], atol=1e-6)
    else:
        jmod, port = jlayers.Decoder(16, 4), tlayers.Decoder(16, 4)
        v = _module_pair(jmod, port, (jq, jkv), 4)
        want = jax.jit(lambda *a: jmod.apply(v, *a, key_mask=jm))(jq, jkv)
        got = port(T(q), T(kv), key_mask=T(key_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_norms_match_flax():
    """flax LayerNorm (``E[x^2] - E[x]^2``) on SpCa-like near-constant
    features (values ~1/N, spread ~1e-4 of them, where its eps shows)
    and on O(1) values, to 1e-6; the token-axis BN over (B, N) in eval
    mode to 1e-6, in train mode to 1e-5 (output) and 1e-6 (running
    statistics)."""
    rng = np.random.default_rng(12)
    for x in (1 / 256 + 1e-4 * rng.standard_normal((2, 9, 16)),
              rng.standard_normal((2, 9, 16))):
        x = x.astype(np.float32)
        ln = fnn.LayerNorm(epsilon=1e-5)
        v = {"params": {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(
            np.float32), "bias": 0.1 * rng.standard_normal(16).astype(
                np.float32)}}
        port = tlayers.LayerNorm(16)
        port.load_state_dict({"weight": T(v["params"]["scale"]),
                              "bias": T(v["params"]["bias"])})
        want = np.asarray(ln.apply(v, jnp.asarray(x)))
        np.testing.assert_allclose(port(T(x)).detach().numpy(), want,
                                   atol=1e-6, rtol=0)
    x = (2 + rng.standard_normal((3, 7, 16))).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = _fill_variables(jax.eval_shape(lambda: bn.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 7, 16)),
        use_running_average=True)), 5)
    port = tlayers.TokenBatchNorm(16)
    port.load_state_dict({"weight": T(v["params"]["scale"]),
                          "bias": T(v["params"]["bias"]),
                          "running_mean": T(v["batch_stats"]["mean"]),
                          "running_var": T(v["batch_stats"]["var"])},
                         strict=False)
    want = bn.apply(v, jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(port.eval()(T(x)).detach().numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)
    want, upd = bn.apply(v, jnp.asarray(x), use_running_average=False,
                         mutable=["batch_stats"])
    got = port.train()(T(x))
    # E[x^2] - E[x]^2 at mean 2, variance 1 over 21 values: the two sides'
    # summation orders part by a few float32 ulps of E[x^2] (~5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, ours).numpy(),
                                   upd["batch_stats"][theirs], atol=1e-6)


# -- head ops -----------------------------------------------------------------

def test_head_ops_match_jax():
    """``second_order_pool`` (masked and not), both distance encodings,
    ``contrastive_loss`` (with and without positives), and QAFF."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    ext = np.array([[4, 5], [2, 3], [1, 1]], np.int32)
    mask = np.zeros((3, 4, 5), np.float32)
    for i, (h, w) in enumerate(ext):
        mask[i, :h, :w] = 1.0
    for m in (None, mask):
        want = jax.jit(jsosnet.second_order_pool)(
            jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = tsosnet.second_order_pool(T(x), None if m is None else T(m))
        assert got.shape == (3, 21)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jax.jit(lambda: jspca.distance_encoding_masks(4, 5, 2))()
    got = tspca.distance_encoding_masks(4, 5, 2, "cpu")
    tm = mask.reshape(3, 20)
    want += jax.jit(lambda m: jspca.masked_distance_encoding_masks(
        4, 5, 2, m))(jnp.asarray(tm))
    got += tspca.masked_distance_encoding_masks(4, 5, 2, T(tm))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7,
                                   rtol=1e-5)
    feats = rng.standard_normal((6, 8)).astype(np.float32)
    for labels in ([0, 0, 1, 2, 1, 3], [0, 1, 2, 3, 4, 5]):
        labels = np.array(labels)
        want = jax.jit(jah.contrastive_loss)(jnp.asarray(feats),
                                             jnp.asarray(labels))
        got = tmodels.contrastive_loss(T(feats), T(labels))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5,
                                   rtol=1e-6)
    jq = jah.QAFF(16)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    sets = [rng.standard_normal((5, 16)).astype(np.float32)
            for _ in range(3)]
    v = _fill_variables(jax.eval_shape(lambda: jq.init(
        jax.random.PRNGKey(0), jnp.asarray(q), [jnp.asarray(s)
                                                for s in sets])), 6)
    port = tmodels.QAFF(16).eval()
    port.load_state_dict(qaff_from_flax(v), strict=True)
    want = jax.jit(lambda *a: jq.apply(v, a[0], list(a[1:])))(
        jnp.asarray(q), *map(jnp.asarray, sets))
    got = port(T(q), [T(s) for s in sets])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(5, 5), (6, 4)])
def test_pyramid_pools_match_jax(hw):
    """Unmasked; masked over extents where a level makes more regions
    than ``level`` per side (5 rows at level 4), fewer (1 x 1 images:
    one region) and remainder cells; only participating regions are
    compared, and those are the same on both sides."""
    rng = np.random.default_rng(14)
    H, W = hw
    x = rng.standard_normal((4, H, W, 3)).astype(np.float32)
    ext = np.array([[H, W], [H, W - 1], [3, 2], [1, 1]], np.int32)
    want = jax.jit(jspoc.spatial_pyramid_pool)(jnp.asarray(x))
    got = tspoc.spatial_pyramid_pool(T(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wpyr, wpart = jax.jit(jspoc.masked_spatial_pyramid_pool)(
        jnp.asarray(x), jnp.asarray(ext))
    gpyr, gpart = tspoc.masked_spatial_pyramid_pool(T(x), T(ext))
    np.testing.assert_array_equal(gpart.numpy(), np.asarray(wpart))
    part = gpart.numpy()
    np.testing.assert_array_equal(gpyr.numpy()[part], np.asarray(wpyr)[part])
    assert part.sum(1).tolist()[-1] == 3  # one region per level


# -- gallery ------------------------------------------------------------------

def test_hybrid_gallery_matches_jax():
    jm, variables = jax_model("adaptive_hybrid_r50")
    port = port_model("adaptive_hybrid_r50", variables)
    jq = jah.QAFF(32)
    qv = _fill_variables(jax.eval_shape(lambda: jq.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32)),
        [jnp.zeros((1, 32))] * 3)), 7)
    qaff = tmodels.QAFF(32)
    qaff.load_state_dict(qaff_from_flax(qv), strict=True)
    rng = np.random.default_rng(15)
    imgs = rng.standard_normal((16, 64, 64, 3)).astype(np.float32)
    queries = imgs[:4] + 0.5 * rng.standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    paths = [f"img{i}.jpg" for i in range(16)]
    jg = JaxGallery(jm, variables, jq, qv, batch_size=8)
    tg = HybridGallery(port, qaff, batch_size=8, device="cpu")
    for g in (jg, tg):  # two adds, one extraction shape
        g.add(imgs[:8], labels=np.arange(8), paths=paths[:8])
        g.add(imgs[8:], labels=np.arange(8, 16), paths=paths[8:])
    assert len(tg) == 16 and tg.labels.tolist() == list(range(16))
    for q in queries:
        ws, wi, wp = jg.search(q, top_k=5)
        gs, gi, gp = tg.search(q, top_k=5)
        assert gs.shape == (1, 5) and gi.dtype == np.int64
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
        gap = np.abs(np.diff(ws, axis=1))
        distinct = np.ones_like(ws, bool)
        distinct[:, 1:] &= gap > 1e-6
        distinct[:, :-1] &= gap > 1e-6
        assert distinct.sum() >= 3
        np.testing.assert_array_equal(gi[distinct], np.asarray(wi)[distinct])
        assert gp == [[paths[j] for j in gi[0]]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            HybridGallery(port, qaff)  # the card by default


# -- registry, presets, entry points ------------------------------------------

def test_registry_and_presets_match_jax():
    port_names = set(tmodels.list_available_models())
    assert {*NEW, "spca_r101"} <= port_names
    for n in port_names:
        assert tmodels.get_model_info(n) == jmodels.get_model_info(n), n
    t1 = {k: v for k, v in jmodels.registry.TABLE1_TO_MODEL_MAPPING.items()
          if v in port_names}
    assert tmodels.TABLE1_TO_MODEL_MAPPING == t1
    for t1_name, cls in (("R101-SpCa", tmodels.SpCaModel),
                         ("R50-SoSNet", tmodels.SoSNetModel),
                         ("R50-SpoC", tmodels.SpoCModel),
                         ("SENet-G2+", tmodels.SENetG2Model)):
        info = tmodels.get_model_info(t1_name)
        assert info["name"] == t1[t1_name]
        builder = tmodels.MODEL_REGISTRY[info["name"]].builder
        assert builder is cls
    for n in ("spca_r101", "sosnet_r50", "spoc_r50", "senet_g2_r50",
              "adaptive_hybrid_r50"):
        got = tconfig.get_preset(n, device="cpu")
        want = jconfig.get_preset(n)
        for f in ("model", "model_overrides", "optimizer", "base_lr",
                  "num_epochs", "batch_size", "imsize"):
            assert getattr(got, f) == getattr(want, f), (n, f)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("zoo_more_imgs")
    rng = np.random.default_rng(16)
    for i in range(3):
        img = rng.integers(0, 256, (64 - 16 * (i % 2), 64, 3), np.uint8)
        cv2.imwrite(str(root / f"{i}.png"), img)
    return root


def _small_head_checkpoint(name, path, **kw):
    """A ``.pt`` of the full ``name`` with an 8-class head (the CLIs size
    the head from the checkpoint; the default 81,313-way one costs more
    to initialize than the extraction)."""
    model = get_model(name, num_classes=8, **kw)
    seeded_init(model, seed=3)
    torch.save(model.state_dict(), path)
    return model


def test_cli_extract_spca_r101(image_dir, tmp_path):
    """The full spca_r101 through ``cli.extract`` at 64 px, single
    scale: unit, finite, distinct 2048-d descriptors."""
    from research_image_retrieval_tpu_torch.cli import extract as cli_extract

    out, ckpt = tmp_path / "g.npz", tmp_path / "spca.pt"
    _small_head_checkpoint("spca_r101", ckpt)
    assert cli_extract.main(["--model", "spca_r101", "--images",
                             str(image_dir), "--imsize", "64", "--output",
                             str(out), "--checkpoint", str(ckpt),
                             "--device", "cpu"]) == 0
    vecs = np.load(out)["vecs"]
    assert vecs.shape == (3, 2048) and np.isfinite(vecs).all()
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
    assert np.abs(vecs[0] - vecs[1]).max() > 1e-3


def test_cli_evaluate_and_serving_extractor(revisited_dir,  # noqa: F811
                                           tmp_path):
    """``cli.evaluate --model senet_g2_r50`` reads a ``.pt`` of the whole
    model (top-level keys, no ``backbone.``) and scores the tiny
    Revisited fixture of ``tests/test_eval_driver.py``; a checkpoint of
    another model still fails the strict check; ``ImageExtractor``
    (``cli.serve --model``) runs adaptive_hybrid_r50."""
    from research_image_retrieval_tpu_torch.cli import evaluate
    from research_image_retrieval_tpu_torch.evaluation.driver import (
        _load_model,
        load_checkpoint,
    )
    from research_image_retrieval_tpu_torch.serve import ImageExtractor
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    model = get_model("senet_g2_r50", layers=(1, 1, 1, 1), num_classes=5)
    seeded_init(model, seed=3)
    ckpt = str(tmp_path / "senet.pt")
    torch.save(model.state_dict(), ckpt)
    sd, backbone_only = load_checkpoint(ckpt)
    assert not backbone_only and set(sd) == set(model.state_dict())
    cfg = EvalConfig(model="senet_g2_r50", checkpoint=ckpt,
                     model_overrides={"layers": (1, 1, 1, 1)})
    loaded = _load_model(cfg, device="cpu")
    assert loaded.classifier.weight.shape == (5, 2048)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(ValueError, match="does not fit"):
        _load_model(EvalConfig(model="sosnet_r50", checkpoint=ckpt,
                               model_overrides={"backbone_name":
                                                "resnet18"}),
                    device="cpu")
    out = str(tmp_path / "res.json")
    _small_head_checkpoint("senet_g2_r50", ckpt)
    assert evaluate.main(["--model", "senet_g2_r50", "--checkpoint", ckpt,
                          "--device", "cpu", "--imsize", "64", "--datasets",
                          "roxford5k", "--data-root", revisited_dir,
                          "--output", out]) == 0
    e, m, h = json.load(open(out))["roxford5k"]
    assert 0.0 <= e <= 100.0 and 0.0 <= h <= 100.0
    ah = str(tmp_path / "ah.pt")
    _small_head_checkpoint("adaptive_hybrid_r50", ah)
    ex = ImageExtractor("adaptive_hybrid_r50", checkpoint=ah, imsize=64,
                        device="cpu")
    rng = np.random.default_rng(17)
    vecs = ex([rng.integers(0, 256, (48, 64, 3), np.uint8)
               for _ in range(2)])
    assert vecs.shape == (2, 2048)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-5)
