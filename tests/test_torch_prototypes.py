"""PyTorch port, the four research prototypes (SPECTRUM, IRIS, SPARSE,
HAMLET) on the CPU against the JAX package, on the same seeded numpy
variables (random BN statistics, SPARSE's quantizer ``scale`` near 1)
converted by ``from_jax_variables``:

* each model's ``extract`` at resnet18, unmasked and on a bucket with
  per-image extents, to 1e-4 on the L2 descriptors; IRIS's CASTLE gates
  and SPARSE's ``k``, mask, bits and codes are compared first, and must
  be equal (a step function compared after the vectors would hide a
  flipped selection behind the 1e-4 bar);
* the modules on their own, to 1e-5: ``BatchCASTLE`` (its mask, with a
  true diagonal), ``BatchNEXUS`` (its keep matrix first), ``PRISM`` with
  the mock text and with real text tokens, ``HARMONY``, the sparse
  encoder and the quantizer (``k``, mask, bits, codes, the straight-through
  value and the loss terms), the distillation head with pooled and token
  text, ``ORACLE``'s row bins masked and unmasked, ``CrossScaleAttention``
  with key masks, ``ContextEnhancedConv`` in eval and in train mode (its
  BN statistics too), ``iris_loss`` and ``hamlet_loss``;
* the registry and the ``sparse_r50`` / ``hamlet_r50`` presets against
  JAX's.

The train steps, the teacher and the training utilities are in
``tests/test_torch_prototypes_train.py``.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.models import hamlet as jhamlet
from research_image_retrieval_tpu.models import iris as jiris
from research_image_retrieval_tpu.models import sparse as jsparse
from research_image_retrieval_tpu.models import spectrum as jspectrum
from research_image_retrieval_tpu.utils import config as jconfig
from research_image_retrieval_tpu_torch import models as tmodels
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.models import hamlet as thamlet
from research_image_retrieval_tpu_torch.models import iris as tiris
from research_image_retrieval_tpu_torch.models import sparse as tsparse
from research_image_retrieval_tpu_torch.models import spectrum as tspectrum
from research_image_retrieval_tpu_torch.utils import config as tconfig
from test_torch_bf16 import _fill_variables
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
NEW = ("spectrum_r50", "iris_r50", "sparse_r50", "hamlet_r50")
IDS = [n.split("_r50")[0] for n in NEW]
# (image side, [B, 2] extents of the masked bucket) per model: IRIS at
# 96 px so that its layer4 map (3 x 3) has rows for the bins to split
GEOMETRY = {
    "spectrum_r50": (64, [[64, 30], [30, 48]]),
    "iris_r50": (96, [[96, 50], [40, 96]]),
    "sparse_r50": (64, [[64, 30], [30, 48]]),
    "hamlet_r50": (64, [[64, 30], [30, 48]]),
}


def overrides(name, **kw):
    """Small configurations: resnet18, 8 classes, 32-d descriptors
    (HAMLET's scales 32 wide, its teacher width 48)."""
    base = dict(backbone_name="resnet18", num_classes=8, outputdim=32)
    if name == "hamlet_r50":
        base.update(hidden=32, text_dim=48)
    if name == "sparse_r50":
        base.update(distill_dim=16, text_dim=48)
    return {**base, **kw}


@functools.cache
def jax_model(name, **kw):
    """(JAX model, seeded numpy variables), shared by both test files.
    IRIS's ``causal_fc2`` bias is moved so that the bucket's two images
    fall on either side of CASTLE's gate (seeded, both are closed)."""
    jm = jmodels.get_model(name, **overrides(name, **kw))
    px = GEOMETRY[name][0]
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    v = _fill_variables(shapes, 0)
    if name == "iris_r50":
        _, calls = jax.jit(lambda x: jm.apply(
            v, x, method="extract", capture_intermediates=True,
            mutable=["intermediates"]))(jnp.asarray(bucket(name)[0]))
        z = calls["intermediates"]["castle"]["causal_fc2"]["__call__"][0]
        fc2 = v["params"]["castle"]["causal_fc2"]
        fc2["bias"] = (fc2["bias"] - np.float32(np.mean(z))).astype(
            np.float32)
    return jm, v


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


# -- whole-model extraction, selections first ---------------------------------

def _jax_selections(name, calls):
    """IRIS's gates / SPARSE's k, mask, bits and codes from the JAX
    ``extract``'s captured intermediates."""
    inter = calls["intermediates"]
    if name == "iris_r50":
        causal = inter["castle"]["causal_fc2"]["__call__"][0]
        return {"gate": np.asarray(jax.nn.sigmoid(causal) > 0.5)}
    sp = inter["sparse"]["__call__"][0]
    q = inter["quant"]["__call__"][0]
    return {"k": np.asarray(jnp.clip(jnp.round(
                sp["mask"].shape[1] * (1.0 - sp["sparsity"][:, 0]))
                .astype(jnp.int32), 1, sp["mask"].shape[1])),
            "mask": np.asarray(sp["mask"]), "bits": np.asarray(q["bits"]),
            "codes": np.asarray(calls["codes"])}


def _port_selections(name, port):
    """Hooks recording the port's selections during ``extract``."""
    got = {}
    if name == "iris_r50":
        def on_causal(mod, args, out):
            got["gate"] = (torch.sigmoid(out) > 0.5).numpy()
        return got, [port.castle.causal_fc2.register_forward_hook(on_causal)]

    def on_sparse(mod, args, out):
        got.update(k=out["k"].numpy(), mask=out["mask"].numpy())

    def on_quant(mod, args, out):
        got.update(bits=out["bits"].numpy(), codes=out["codes"].numpy())

    return got, [port.sparse.register_forward_hook(on_sparse),
                 port.quant.register_forward_hook(on_quant)]


def _jax_codes(qp, sparse_features, bits):
    """``round(clip(x / scale + zero_point, 0, 2^bits - 1))`` with the
    JAX quantizer's parameters ``qp``."""
    x = sparse_features / (jnp.abs(qp["scale"]) + 1e-6) + qp["zero_point"]
    return jnp.round(jnp.clip(x, 0.0, 2.0 ** bits - 1.0))


@pytest.mark.parametrize("name", NEW, ids=IDS)
def test_extract_matches_jax(name):
    jm, variables = jax_model(name)
    port = port_model(name, variables).eval()
    x, ext = bucket(name)
    selects = name in ("iris_r50", "sparse_r50")

    @jax.jit
    def jext(x, e):
        outs = []
        for v in (None, e):
            out, calls = jm.apply(variables, x, v, method="extract",
                                  capture_intermediates=True,
                                  mutable=["intermediates"])
            calls = dict(calls)
            if name == "sparse_r50":
                inter = calls["intermediates"]
                calls["codes"] = _jax_codes(
                    variables["params"]["quant"],
                    inter["sparse"]["__call__"][0]["sparse_features"],
                    inter["quant"]["__call__"][0]["bits"])
            outs.append((out, calls))
        return outs

    want = jext(jnp.asarray(x), jnp.asarray(ext))
    for (w, calls), v, what in zip(want, (None, T(ext)),
                                   ("extract", "masked")):
        got, hooks = (_port_selections(name, port) if selects
                      else ({}, []))
        with torch.no_grad():
            g = port.extract(T(x), v).numpy()
        for h in hooks:
            h.remove()
        if selects:
            jsel = _jax_selections(name, calls)
            if name == "iris_r50" and what == "extract":
                assert jsel["gate"].sum() == 1  # one open, one closed
            for key in jsel:
                np.testing.assert_array_equal(
                    np.asarray(got[key]).reshape(jsel[key].shape),
                    jsel[key], err_msg=f"{what} {key}")
        w = np.asarray(w)
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)
        if what == "extract":
            unmasked = g
    assert np.abs(g - unmasked).max() > 1e-3  # the masks mattered


# -- the modules on their own ---------------------------------------------------

def _pair(jmod, tmod, *args, seed=0, **kw):
    """(flax variables filled from ``seed``, the port module loaded from
    them)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args,
                                              **kw))
    v = _fill_variables(shapes, seed)
    tmod.load_state_dict(from_jax_variables(v), strict=True)
    return v, tmod


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0, err_msg=what)


def _feats(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_batch_castle_and_nexus_match_jax():
    """The causal mask (diagonal 1, some pairs off) and NEXUS's keep
    matrix (each row keeps itself) are compared before the vectors."""
    f = _feats((6, 32))
    jc = jspectrum.BatchCASTLE(32)
    v, tc = _pair(jc, tspectrum.BatchCASTLE(32), jnp.asarray(f))
    (jo, jmask) = jax.jit(jc.apply)(v, jnp.asarray(f))
    with torch.no_grad():
        to, tmask = tc(T(f))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert bool(jspectrum.BatchCASTLE.causal_mask_diagonal_is_one(jmask))
    assert tmask.diagonal().all() and not tmask.all()
    _close(to, jo)

    jn = jspectrum.BatchNEXUS(32)
    v, tn = _pair(jn, tspectrum.BatchNEXUS(32), jnp.asarray(f), seed=1)
    jo, jkeep = jax.jit(jn.apply)(v, jnp.asarray(f))
    with torch.no_grad():
        to, tkeep = tn(T(f))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert tkeep.diagonal().all()
    assert 1 < int(tkeep.sum(1).max()) and int(tkeep.sum(1).min()) < 6
    _close(to, jo)


def test_prism_and_harmony_match_jax():
    f = _feats((4, 32))
    text = _feats((4, 3, 384), seed=4)
    jp = jspectrum.PRISM(32)
    v, tp = _pair(jp, tspectrum.PRISM(32), jnp.asarray(f))
    for t in (None, text):  # the mock text, then real text tokens
        want = jax.jit(jp.apply)(v, jnp.asarray(f),
                                 None if t is None else jnp.asarray(t))
        with torch.no_grad():
            got = tp(T(f), None if t is None else T(t))
        _close(got["fused"], want["fused"], what=f"fused, text {t is None}")
        _close(got["text_proj"], want["text_proj"])
    jh = jspectrum.HARMONY(32)
    branches = [_feats((4, 32), seed=s) for s in range(4)]
    v, th = _pair(jh, tspectrum.HARMONY(32),
                  [jnp.asarray(b) for b in branches])
    want = jax.jit(jh.apply)(v, [jnp.asarray(b) for b in branches])
    with torch.no_grad():
        _close(th([T(b) for b in branches]), want)


def test_sparse_encoder_and_quantizer_match_jax():
    """``k``, mask, bits and codes equal; the sparse and straight-through
    vectors and every loss term to 1e-5.  The quantizer's input is
    scaled so that codes span several levels."""
    x = 3.0 * _feats((4, 32))
    je = jsparse.AdaptiveSparseEncoder(32)
    v, te = _pair(je, tsparse.AdaptiveSparseEncoder(32), jnp.asarray(x))
    want = jax.jit(je.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = te(T(x))
    k = np.clip(np.round(32 * (1.0 - np.asarray(want["sparsity"])[:, 0])),
                1, 32)
    np.testing.assert_array_equal(got["k"].numpy(), k)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert 0 < float(got["mask"].mean()) < 1
    for key in ("sparse_features", "sparsity", "actual_sparsity", "l1_reg"):
        _close(got[key], want[key], what=key)

    xs = np.asarray(want["sparse_features"])
    jq = jsparse.SemanticPreservingQuantization(32)
    v, tq = _pair(jq, tsparse.SemanticPreservingQuantization(32),
                  jnp.asarray(xs), seed=2)
    want = jax.jit(jq.apply)(v, jnp.asarray(xs))
    with torch.no_grad():
        got = tq(T(xs))
    np.testing.assert_array_equal(got["bits"].numpy(),
                                  np.asarray(want["bits"]))
    codes = np.asarray(_jax_codes(v["params"], jnp.asarray(xs),
                                  want["bits"]))
    np.testing.assert_array_equal(got["codes"].numpy(), codes)
    assert len(np.unique(codes)) > 2
    # the straight-through value rounds as JAX's x + stop_gradient(...)
    np.testing.assert_array_equal(got["quantized_features"].numpy(),
                                  np.asarray(want["quantized_features"]))
    for key in ("importance", "avg_bits", "recon_loss", "semantic_loss",
                "quant_loss"):
        _close(got[key], want[key], what=key)


def test_distillation_head_matches_jax():
    """InfoNCE against pooled and token-sequence teacher rows; the
    ``text_proj`` parameters exist without a teacher too."""
    f = _feats((4, 32))
    jd = jsparse.LLMKnowledgeDistillation(embed_dim=16, text_dim=48)
    v, td = _pair(jd, tsparse.LLMKnowledgeDistillation(32, 16, 48),
                  jnp.asarray(f))
    assert "text_proj" in v["params"]
    for text in (_feats((4, 48), seed=5), _feats((4, 3, 48), seed=6)):
        want = jax.jit(jd.apply)(v, jnp.asarray(f), jnp.asarray(text))
        with torch.no_grad():
            got = td(T(f), T(text))
        for key in ("visual_embed", "distill_embed", "text_embed",
                    "distill_loss"):
            _close(got[key], want[key], what=key)
        assert float(got["distill_loss"]) > 0
    with torch.no_grad():
        assert float(td(T(f))["distill_loss"]) == 0.0


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_oracle_matches_jax(masked):
    """ORACLE on a [2, 5, 4, 16] map: the row bins (what ``obj_proj``
    reads) over the true heights (5 and 3 rows into 8 bins, so bins
    overlap), then the whole module."""
    fmap = np.abs(_feats((2, 5, 4, 16)))
    ext = np.array([[5, 4], [3, 2]], np.int32) if masked else None
    jext = None if ext is None else jnp.asarray(ext)
    jo = jiris.ORACLE(output_dim=32)
    v, to = _pair(jo, tiris.ORACLE(16, 32), jnp.asarray(fmap), extents=jext)

    def apply(fm, e):
        seen = {}

        def grab(next_fun, args, kwargs, context):
            if context.module.name == "obj_proj":
                seen["bins"] = args[0]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(grab):
            return jo.apply(v, fm, extents=e), seen["bins"]

    want, wbins = jax.jit(apply)(jnp.asarray(fmap), jext)
    seen = {}
    hook = to.obj_proj.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("bins", args[0]))
    with torch.no_grad():
        got = to(T(fmap), None if ext is None else T(ext))
    hook.remove()
    _close(seen["bins"], wbins, what="bins")
    _close(got, want)


def test_cross_scale_attention_and_context_conv_match_jax():
    """CrossScaleAttention over three scales with per-image key masks;
    ContextEnhancedConv in eval mode (masked) and in train mode (batch
    statistics, and the running statistics it leaves)."""
    shapes = ((2, 4, 4, 16), (2, 2, 2, 16), (2, 1, 1, 16))
    feats = [_feats(s, seed=i) for i, s in enumerate(shapes)]
    masks = [np.ones((2, s[1] * s[2]), np.float32) for s in shapes]
    masks[0][1, 8:] = 0.0
    masks[1][1, 2:] = 0.0
    jx = jhamlet.CrossScaleAttention(16)
    v, tx = _pair(jx, thamlet.CrossScaleAttention(16),
                  [jnp.asarray(f) for f in feats])
    want = jax.jit(lambda f, m: jx.apply(v, f, token_masks=m))(
        [jnp.asarray(f) for f in feats], [jnp.asarray(m) for m in masks])
    with torch.no_grad():
        got = tx([T(f) for f in feats], [T(m) for m in masks])
    for g, w in zip(got, want):
        _close(g, w)

    x = _feats((2, 5, 5, 16), seed=7)
    m = np.ones((2, 5, 5), np.float32)
    m[1, 3:] = 0.0
    m[1, :, 4:] = 0.0
    jc = jhamlet.ContextEnhancedConv(16)
    v, tc = _pair(jc, thamlet.ContextEnhancedConv(16), jnp.asarray(x))
    want = jax.jit(lambda x, m: jc.apply(v, x, mask=m))(jnp.asarray(x),
                                                        jnp.asarray(m))
    with torch.no_grad():
        _close(tc.eval()(T(x), T(m)), want, what="eval")
    want, upd = jax.jit(lambda x: jc.apply(v, x, train=True,
                                           mutable=["batch_stats"]))(
        jnp.asarray(x))
    with torch.no_grad():
        _close(tc.train()(T(x)), want, what="train")
    sd = tc.state_dict()
    for bn in ("bn1", "bn2"):
        _close(sd[f"{bn}.running_mean"], upd["batch_stats"][bn]["mean"])
        _close(sd[f"{bn}.running_var"], upd["batch_stats"][bn]["var"])


def test_iris_and_hamlet_losses_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 8)).astype(np.float32)
    feats = rng.standard_normal((6, 32)).astype(np.float32)
    labels = np.array([1, 1, 2, 3, 3, 3])
    want = jiris.iris_loss(jnp.asarray(logits), jnp.asarray(feats),
                           jnp.asarray(labels))
    got = tiris.iris_loss(T(logits), T(feats), T(labels))
    _close(got, want)
    descs = [rng.standard_normal((6, 16)).astype(np.float32)
             for _ in range(3)]
    teacher = rng.standard_normal((6, 48)).astype(np.float32)
    student = rng.standard_normal((6, 48)).astype(np.float32)
    for t, s in ((None, None), (teacher, student)):
        wl, waux = jhamlet.hamlet_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            [jnp.asarray(d) for d in descs],
            None if t is None else jnp.asarray(t),
            None if s is None else jnp.asarray(s))
        gl, gaux = thamlet.hamlet_loss(
            T(logits), T(labels), [T(d) for d in descs],
            None if t is None else T(t), None if s is None else T(s))
        assert sorted(gaux) == sorted(waux)
        _close(gl, wl)
        for k in waux:
            _close(gaux[k], waux[k], what=k)


# -- registry and presets -------------------------------------------------------

def test_registry_and_presets_match_jax():
    for name in NEW:
        assert tmodels.get_model_info(name)["defaults"] == \
            jmodels.get_model_info(name)["defaults"]
        assert tmodels.get_model_info(name)["family"] == \
            jmodels.get_model_info(name)["family"]
    for name in ("sparse_r50", "hamlet_r50"):
        assert tconfig.PRESETS[name] == jconfig.PRESETS[name]
        cfg = tconfig.get_preset(name)
        assert (cfg.model, cfg.optimizer, cfg.base_lr) == (name, "adamw",
                                                           1e-3)
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    assert set(jmodels.list_available_models()) <= set(
        tmodels.list_available_models())
