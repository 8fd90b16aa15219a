"""PyTorch port, the transformer step of the zoo on the CPU against the
JAX package, on the same seeded numpy variables converted by
``from_jax_variables`` (JAX's tiny configurations: ULTRON ``t`` at 64 px
with window 4, ViT ``test``, CLIP ``test`` / ``rtest``):

* ``dynamic_resize_weights`` against JAX's to 1e-6;
* ``extract_vectors(extent_multiple=...)`` on image sizes that are no
  multiple of the model's grid, single scale (host path) and ms3 (raw
  uint8, scales on the device), against JAX's ``extract_vectors`` on the
  same images to 1e-5; ``_snap`` and the driver's probe;
* each family's ``extract``, unmasked and on a bucket with per-image
  extents, to 1e-4;
* a ModifiedResNet with identity blocks (layers (2, 2, 1, 1), width 8):
  those blocks go through ``fused_bottleneck`` (its plain version on the
  CPU) with their stage's extents, to 1e-4 against JAX's module path;
  at bf16 they take the kernel's bf16 form;
* ``madacos_loss`` at odd and even batches, loss and gradient to 1e-5;
* the CLIP converter on seeded OpenAI-layout state dicts (ViT and
  ResNet towers, text tower, contrastive loss) against JAX's
  ``build_clip_from_torch``, and ``load_clip_visual_into``.

The train steps, ``cli.train --preset ultron_s`` across the optimizer
hand-off and the registry are in ``test_torch_transformer_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.index import extract as jextract
from research_image_retrieval_tpu.models import clip_convert as jconvert
from research_image_retrieval_tpu.models import clip_resnet as jclip_resnet
from research_image_retrieval_tpu.ops import losses as jlosses
from research_image_retrieval_tpu.ops import masking as jmasking
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.evaluation.driver import (
    _make_extract_fn,
)
from research_image_retrieval_tpu_torch.index import extract as textract
from research_image_retrieval_tpu_torch import models as tmodels
from research_image_retrieval_tpu_torch.models import (
    backbone as tbackbone,
    clip_convert as tconvert,
    clip_resnet as tclip_resnet,
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.ops import losses as tlosses
from research_image_retrieval_tpu_torch.ops import masking as tmasking
from test_clip_convert import _make_rn_sd, _make_vit_sd
from test_torch_bf16 import _fill_variables
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
PX = 64
NORM = (IMAGENET_MEAN, IMAGENET_STD)
# registry name and tiny overrides (tests/test_model_zoo.py's) per family
CASES = {
    "ultron": ("ultron_s", dict(variant="t", img_size=PX, window_size=4)),
    "vit": ("vit_s16", dict(variant="test", outputdim=32, img_size=PX)),
    "clip_vit": ("clip_vit_b32", dict(variant="test", outputdim=24,
                                      img_size=PX)),
    "clip_rn": ("clip_r50", dict(variant="rtest", outputdim=24,
                                 img_size=PX)),
}
# a bucket per family: canvas side and extents its contract allows
BUCKETS = {
    "ultron": (96, [[96, 64], [64, 32]]),
    "vit": (64, [[64, 40], [48, 64]]),
    "clip_vit": (64, [[64, 40], [48, 64]]),
    "clip_rn": (64, [[64, 45], [37, 64]]),
}


def overrides(kind, **kw):
    return {**CASES[kind][1], "num_classes": 8, **kw}


def seeded_variables(shapes, seed=0):
    """``_fill_variables`` with ULTRON's pooling ``gamma`` at its init
    value 2.0 (a random draw near 0 makes ``x ** (1 / gamma)``
    overflow), as JAX arrays."""
    v = _fill_variables(shapes, seed)
    pool = v["params"].get("global_pool")
    if pool is not None:
        pool["gamma"] = np.asarray(2.0, np.float32)
    # JAX arrays: ULTRON indexes its bias table with a traced index
    return jax.tree_util.tree_map(jnp.asarray, v)


@functools.cache
def jax_model(kind):
    name = CASES[kind][0]
    jm = jmodels.get_model(name, **overrides(kind))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    return jm, seeded_variables(shapes)


def port_model(kind, variables, **kw):
    port = get_model(CASES[kind][0], **overrides(kind, **kw))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


def bucket(kind, seed=1):
    side, ext = BUCKETS[kind]
    ext = np.array(ext, np.int32)
    x = np.random.default_rng(seed).standard_normal(
        (len(ext), side, side, 3)).astype(np.float32)
    for i, (h, w) in enumerate(ext):
        x[i, h:] = 0.0
        x[i, :, w:] = 0.0
    return x, ext


# -- ops -----------------------------------------------------------------------

@pytest.mark.parametrize("n_out, n_in, true_out", [
    (12, 4, [12, 7, 3]), (6, 14, [6, 5, 1]), (9, 9, [9, 4, 8])])
def test_dynamic_resize_weights_matches_jax(n_out, n_in, true_out):
    """Up, down and same-size resizes, to each image's true length inside
    the padded grid, at 1e-6."""
    t = np.array(true_out, np.int32)
    want = np.asarray(jax.jit(jmasking.dynamic_resize_weights,
                              static_argnums=(0, 1))(n_out, n_in, t))
    got = tmasking.dynamic_resize_weights(n_out, n_in, T(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for b, n in enumerate(true_out):
        assert not got[b, n:].any()


@pytest.mark.parametrize("batch", [5, 6], ids=["odd", "even"])
def test_madacos_loss_matches_jax(batch):
    """Loss, scale, margin, logits and the gradient of the features and
    the class weights to 1e-5 (relative to each's largest magnitude); the
    lower median on the even batch; eval's fixed margin 0."""
    rng = np.random.default_rng(batch)
    f = rng.standard_normal((batch, 16)).astype(np.float32)
    w = rng.standard_normal((10, 16)).astype(np.float32)
    y = rng.integers(0, 10, batch)

    def jloss(f, w, fm):
        loss, aux = jlosses.madacos_loss(f, w, jnp.asarray(y),
                                         fixed_margin=fm)
        return loss, aux

    for fm in (None, 0.0):
        (jl, jaux), (gf, gw) = jax.jit(
            jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
            static_argnums=2)(f, w, fm)
        tf, tw = T(f).requires_grad_(), T(w).requires_grad_()
        tl, taux = tlosses.madacos_loss(tf, tw, T(y), fixed_margin=fm)
        tl.backward()
        for got, want in ((tl, jl), (taux["scale"], jaux["scale"]),
                          (taux["margin"], jaux["margin"]),
                          (taux["logits"], jaux["logits"]),
                          (tf.grad, gf), (tw.grad, gw)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                np.asarray(torch.as_tensor(got).detach()), want,
                atol=1e-5 * max(np.abs(want).max(), 1.0), rtol=0)
    cos = (f / np.linalg.norm(f, axis=1, keepdims=True)) @ (
        w / np.linalg.norm(w, axis=1, keepdims=True)).T
    lower = np.sort(cos[np.arange(batch), y])[(batch - 1) // 2]
    want_scale = np.log(0.9 * 0.96 / 0.1) / (1 - lower + 1e-8)
    assert abs(float(taux["scale"]) - want_scale) < 1e-4 * want_scale


# -- extraction with extent_multiple ------------------------------------------

def test_snap_matches_jax():
    for v in range(1, 200):
        for m in (8, 16, 32):
            assert textract._snap(v, m) == jextract._snap(v, m)
    assert textract._snap(68, 8) == 64 and textract._snap(76, 8) == 80


def test_driver_probe_surfaces_extent_multiple():
    """``_make_extract_fn`` returns the model's multiple (1 for a model
    without one, and for CLIP's ModifiedResNet tower); a model whose
    ``extract`` takes no extents falls back to exact shapes."""
    for kind, want in (("ultron", 32), ("vit", 8), ("clip_vit", 8),
                       ("clip_rn", 1)):
        model = get_model(CASES[kind][0], **overrides(kind))
        _, bucket_, multiple = _make_extract_fn(model, bucket=128)
        assert (bucket_, multiple) == (128, want), kind
    gem = get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                    num_classes=4)
    assert _make_extract_fn(gem, bucket=64)[1:] == (64, 1)

    class NoExtents:
        def extract(self, x):
            return x

    assert _make_extract_fn(NoExtents(), bucket=64)[1:] == (None, 1)


@pytest.mark.parametrize("kind", ["ultron", "vit", "clip_vit"])
@pytest.mark.parametrize("path", ["single", "ms3_device"])
def test_extract_vectors_extent_multiple_matches_jax(kind, path):
    """Images whose sides are no multiple of the model's grid: the port's
    ``extract_vectors`` against JAX's with the model's
    ``extent_multiple``, single scale through the host path (float
    images) and ms3 with raw uint8 resized on the device, to 1e-5."""
    jm, variables = jax_model(kind)
    port = port_model(kind, variables).eval()
    multiple = port.extent_multiple
    assert multiple == jm.extent_multiple
    rng = np.random.default_rng(3)
    if path == "single":
        sizes = [(70, 91), (61, 70), (87, 66)]
        imgs = [rng.standard_normal((h, w, 3)).astype(np.float32)
                for h, w in sizes]
        kw = dict(scales=(1.0,), bucket=32, batch_size=2)
    else:
        sizes = [(100, 131), (93, 77), (131, 101)]
        imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for h, w in sizes]
        kw = dict(scales=(1.0, 2 ** -0.5, 0.5), bucket=32, batch_size=2,
                  device_scales=True, input_norm=NORM)
    assert all(h % multiple and w % multiple for h, w in sizes)
    jfn = jax.jit(lambda x, e: jm.apply(variables, x, e, method="extract"))
    want = jextract.extract_vectors(jfn, imgs, extent_multiple=multiple,
                                    **kw)
    with torch.no_grad():
        got = textract.extract_vectors(lambda x, e: port.extract(x, e), imgs,
                                       extent_multiple=multiple,
                                       device="cpu", **kw)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


# -- whole-model extraction ----------------------------------------------------

@pytest.mark.parametrize("kind", list(CASES))
def test_transformer_extract_matches_jax(kind):
    jm, variables = jax_model(kind)
    port = port_model(kind, variables).eval()
    x, ext = bucket(kind)

    @jax.jit
    def jext(x, e):
        return (jm.apply(variables, x, method="extract"),
                jm.apply(variables, x, e, method="extract"))

    want = [np.asarray(w) for w in jext(jnp.asarray(x), jnp.asarray(ext))]
    with torch.no_grad():
        got = [port.extract(T(x)).numpy(), port.extract(T(x), T(ext)).numpy()]
    for g, w, what in zip(got, want, ("extract", "masked")):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)
    assert np.abs(got[1] - got[0]).max() > 1e-3  # the masks mattered


def _modified_resnet(dtype=torch.float32):
    """JAX ``ModifiedResNet(layers=(2, 2, 1, 1), width=8)`` with seeded
    variables and the port's from them (two identity blocks)."""
    kw = dict(layers=(2, 2, 1, 1), width=8, output_dim=24,
              input_resolution=PX)
    jm = jclip_resnet.ModifiedResNet(**kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)), train=False))
    variables = seeded_variables(shapes)
    port = tclip_resnet.ModifiedResNet(**kw, dtype=dtype)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, port.eval()


def _recorded_bottleneck(monkeypatch):
    calls = []
    real = tbackbone.fused_bottleneck

    def recorded(x, *ws, extents=None):
        calls.append((x.shape, x.dtype,
                      None if extents is None else extents.clone()))
        return real(x, *ws, extents=extents)

    monkeypatch.setattr(tbackbone, "fused_bottleneck", recorded)
    return calls


def test_modified_resnet_identity_blocks_run_the_kernel(monkeypatch):
    """The stride-1 identity blocks (layer1.1, layer2.1) go through
    ``fused_bottleneck`` in eval mode, with the stage's extents (the stem
    ceil-halves, each average pool floor-halves); unmasked and masked
    outputs to 1e-4 against JAX's module path."""
    jm, variables, port = _modified_resnet()
    calls = _recorded_bottleneck(monkeypatch)
    x, ext = bucket("clip_rn")

    @jax.jit
    def jfwd(x, e):
        return jm.apply(variables, x), jm.apply(variables, x, valid_hw=e)

    want = [np.asarray(w) for w in jfwd(jnp.asarray(x), jnp.asarray(ext))]
    with torch.no_grad():
        got = [port(T(x)).numpy(), port(T(x), T(ext)).numpy()]
    for g, w, what in zip(got, want, ("unmasked", "masked")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)
    assert np.abs(got[1] - got[0]).max() > 1e-3
    assert len(calls) == 4  # two identity blocks per pass
    stem = np.maximum((ext + 1) // 2 // 2, 1)  # ceil-half, floor-half
    for i, (shape, dt, e) in enumerate(calls):
        assert dt == torch.float32
        if i < 2:
            assert e is None
        else:
            want_e = stem if i == 2 else np.maximum(stem // 2, 1)
            np.testing.assert_array_equal(e.numpy(), want_e)
            assert shape[1] == (16 if i == 2 else 8)


def test_modified_resnet_bf16_runs_the_bf16_kernel_form(monkeypatch):
    """At bf16 the identity blocks hand bf16 maps to ``fused_bottleneck``
    (the kernel's bf16 form on the card); the pooled output is fp32 and
    within bf16's rounding of the fp32 tower (cosine > 0.999)."""
    _, _, port32 = _modified_resnet()
    _, _, port16 = _modified_resnet(torch.bfloat16)
    calls = _recorded_bottleneck(monkeypatch)
    x, ext = bucket("clip_rn")
    with torch.no_grad():
        a = port32(T(x), T(ext))
        calls.clear()
        b = port16(T(x), T(ext))
    assert [c[1] for c in calls] == [torch.bfloat16] * 2
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    assert cos.min() > 0.999, cos


# -- the CLIP converter --------------------------------------------------------

TOKENS = np.array([[1, 5, 9, 63, 0, 0, 0, 0, 0, 0, 0, 0],
                   [2, 8, 3, 4, 7, 63, 0, 0, 0, 0, 0, 0]], np.int64)


@pytest.mark.parametrize("tower, res", [("vit", 32), ("rn", 64)])
def test_clip_converter_matches_jax(tower, res):
    """``build_clip_from_torch`` on a seeded OpenAI-layout state dict (the
    JAX tests' generators): the inferred config equals JAX's; image
    features (exact shape, and masked on a bucket), text features and
    the contrastive loss at 1e-5 against the JAX CLIP built from the
    same dict; that JAX CLIP's variables through ``from_jax_variables``
    give the converter's model exactly."""
    sd = (_make_vit_sd if tower == "vit" else _make_rn_sd)()
    jm, jv = jconvert.build_clip_from_torch(sd)
    port, _ = tconvert.build_clip_from_torch(sd)
    _, config = tconvert.convert_torch_clip(sd)
    assert config == jconvert.convert_torch_clip(sd)[1]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    ext = np.array([[res, res // 2], [res - 8, res]], np.int32)
    xm = x.copy()
    for i, (h, w) in enumerate(ext):
        xm[i, h:] = 0.0
        xm[i, :, w:] = 0.0

    @jax.jit
    def jfwd(x, xm, e, tok):
        im = jm.apply(jv, x, method="image_features")
        imm = jm.apply(jv, xm, e, method="image_features")
        tx = jm.apply(jv, tok, method="text_features")
        loss, _ = jm.apply(jv, x, tok)
        return im, imm, tx, loss

    want = [np.asarray(w) for w in jfwd(x, xm, ext, TOKENS.astype(np.int32))]
    with torch.no_grad():
        got = [port.image_features(T(x)).numpy(),
               port.image_features(T(xm), T(ext)).numpy(),
               port.text_features(T(TOKENS)).numpy(),
               port(T(x), T(TOKENS))[0].numpy()]
    for g, w, what in zip(got, want, ("image", "masked", "text", "loss")):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=what)
    # the JAX CLIP's own variables (text tower, DenseGeneral attention,
    # Embed) through from_jax_variables give the same model
    bridged = tmodels.CLIP(**config)
    bridged.load_state_dict(from_jax_variables(jv), strict=True)
    with torch.no_grad():
        again = [bridged.eval().image_features(T(x)).numpy(),
                 bridged.text_features(T(TOKENS)).numpy()]
    for g, w in zip(again, (got[0], got[2])):
        np.testing.assert_array_equal(g, w)


def test_load_clip_visual_into_registry_models():
    """``clip_r50`` / ``clip_vit_b32`` at the tiny variants take an
    OpenAI-layout checkpoint's visual tower; their ``extract`` equals the
    JAX model's after JAX's ``load_clip_visual_into``, at 1e-5."""
    for make_sd, kind, res in ((_make_rn_sd, "clip_rn", 64),
                               (_make_vit_sd, "clip_vit", 32)):
        sd = make_sd()
        kw = overrides(kind, img_size=res)
        jm = jmodels.get_model(CASES[kind][0], **kw)
        jv = jax.jit(lambda k, x, y: jm.init(k, x, labels=y, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)),
            jnp.zeros((1,), jnp.int32))
        jv = jconvert.load_clip_visual_into(jv, sd)
        port = get_model(CASES[kind][0], **kw)
        assert tconvert.load_clip_visual_into(port, sd) is port
        x = np.random.default_rng(9).standard_normal(
            (2, res, res, 3)).astype(np.float32)
        want = np.asarray(jax.jit(lambda x: jm.apply(
            jv, x, method="extract"))(x))
        with torch.no_grad():
            got = port.eval().extract(T(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=kind)


# -- the entry points pass the model's multiple --------------------------------

def test_entry_points_pass_the_multiple(monkeypatch):
    """``evaluate_synthetic`` (the evaluation driver), ``cli.extract``'s
    ``extract_index`` and ``ImageExtractor`` hand ``extract_vectors`` the
    model's ``extent_multiple``; the service's descriptor of an image
    whose sides are no multiple of 16 equals the direct extraction of it
    with the multiple, and differs from one without it."""
    from research_image_retrieval_tpu_torch import index as tindex
    from research_image_retrieval_tpu_torch.cli.extract import extract_index
    from research_image_retrieval_tpu_torch.evaluation import driver
    from research_image_retrieval_tpu_torch.serve import ImageExtractor
    from research_image_retrieval_tpu_torch.serve import service as tservice
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    seen = []

    def recording(real):
        def fn(*args, **kw):
            seen.append(kw.get("extent_multiple"))
            return real(*args, **kw)
        return fn

    monkeypatch.setattr(driver, "extract_vectors",
                        recording(driver.extract_vectors))
    monkeypatch.setattr(tindex, "extract_vectors",
                        recording(tindex.extract_vectors))
    monkeypatch.setattr(tservice, "extract_vectors",
                        recording(tservice.extract_vectors))
    _, variables = jax_model("vit")
    vit = port_model("vit", variables).eval()
    driver.evaluate_synthetic(vit, EvalConfig(imsize=64, bucket=32),
                              device="cpu")
    _, variables = jax_model("ultron")
    ultron = port_model("ultron", variables).eval()
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (70, 91, 3), dtype=np.uint8)]
    out = extract_index(ultron, imgs, ["a"], imsize=0, batch_size=2,
                        device="cpu")
    assert out["vecs"].shape == (1, 64) and np.isfinite(out["vecs"]).all()
    assert seen == [8, 32]
    svc = ImageExtractor("vit_s16", imsize=0, device="cpu")
    assert svc._multiple == 16
    got = svc(imgs)
    assert seen[-1] == 16
    fn = lambda x, v: svc._model.extract(x, v)  # noqa: E731
    kw = dict(bucket=128, device_scales=True, input_norm=NORM, device="cpu")
    with torch.no_grad():
        want = textract.extract_vectors(fn, imgs, extent_multiple=16, **kw)
        plain = textract.extract_vectors(fn, imgs, **kw)
    np.testing.assert_array_equal(got, want)
    assert np.abs(plain - want).max() > 1e-3
