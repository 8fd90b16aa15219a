"""PyTorch port, the ResNet zoo families (DOLG, SOLAR, DELG) on the CPU
against the JAX package, on the same seeded numpy variables (random BN
statistics, SOLAR's ``v`` nonzero so the attention counts) converted by
``from_jax_variables``:

* each family's ``extract`` at resnet18, 64 px, unmasked and on a
  bucket with per-image extents, to 1e-4; DELG's ``extract_local``
  (locals and attention) to 1e-4; dolg once with ASPP;
* a ``stride_on_conv1`` bottleneck (stride 2) against the flax block to
  1e-5 in eval mode (with extents) and in train mode (output and running
  statistics);
* the pycls and features converters against the JAX ones followed by
  ``from_jax_variables``: the same keys, arrays equal;
* the pooling, masking and DELG-ArcFace ops to 1e-6;
* the registry's names, Table-1 names, ``get_model_info`` and the
  presets against JAX's;
* a bf16 solar_r50 extract against JAX's at 3x JAX's own one-bf16-ulp
  floor, as ``tests/test_torch_bf16.py`` states it.

One SGD step per family is held against JAX in
``tests/test_torch_zoo_train.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.models import backbone as jbackbone
from research_image_retrieval_tpu.ops import losses as jlosses
from research_image_retrieval_tpu.ops import masking as jmasking
from research_image_retrieval_tpu.ops import pooling as jpooling
from research_image_retrieval_tpu.utils import config as jconfig
from research_image_retrieval_tpu_torch import models as tmodels
from research_image_retrieval_tpu_torch.models import (
    BottleneckBlock,
    from_jax_variables,
    get_model,
    load_features_resnet,
    load_pycls_resnet,
)
from research_image_retrieval_tpu_torch.models.convert import _heads_from_flax
from research_image_retrieval_tpu_torch.ops import losses as tlosses
from research_image_retrieval_tpu_torch.ops import masking as tmasking
from research_image_retrieval_tpu_torch.ops import pooling as tpooling
from research_image_retrieval_tpu_torch.utils import config as tconfig
from test_torch_bf16 import BF, _fill_variables, bumps
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
FAMILIES = ("dolg_r50", "solar_r50", "delg_r50")


def _overrides(name, **kw):
    kw = dict(backbone_name="resnet18", num_classes=8, outputdim=32, **kw)
    if name == "delg_r50":  # DELG keeps its 2048-d global feature
        del kw["outputdim"]
    return kw


@functools.cache
def _jax_model(name, aspp=False):
    """(JAX model, seeded variables) at 64 px, shared by the tests."""
    jm = jmodels.get_model(name, **_overrides(name, **(
        {"with_aspp": True} if aspp else {})))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    return jm, _fill_variables(shapes, 0)


def _port(name, variables, aspp=False):
    port = get_model(name, **_overrides(name, **(
        {"with_aspp": True} if aspp else {})))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


# -- whole-model extraction ---------------------------------------------------

@pytest.mark.parametrize("name, aspp", [
    ("dolg_r50", False), ("dolg_r50", True), ("solar_r50", False),
    ("delg_r50", False)], ids=["dolg", "dolg-aspp", "solar", "delg"])
def test_zoo_extract_matches_jax(name, aspp):
    """Unmasked 64 px, and a 64 px bucket whose images are 64 x 30 and
    30 x 48 (layer4 extents 2 x 1 and 1 x 2, layer3 4 x 2 and 2 x 3)."""
    jm, variables = _jax_model(name, aspp)
    port = _port(name, variables, aspp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ext = np.array([[64, 30], [30, 48]], np.int32)
    x[0, :, 30:] = 0.0
    x[1, 30:] = 0.0
    x[1, :, 48:] = 0.0
    local = name == "delg_r50"

    @jax.jit
    def jext(x, e):
        out = (jm.apply(variables, x, method="extract"),
               jm.apply(variables, x, e, method="extract"))
        return out + (jm.apply(variables, x, method="extract_local")
                      if local else ())

    want = list(map(np.asarray, jext(jnp.asarray(x), jnp.asarray(ext))))
    port.eval()
    with torch.no_grad():
        got = [port.extract(T(x)), port.extract(T(x), T(ext))]
        if local:
            got += port.extract_local(T(x))
    got = [t.numpy() for t in got]
    for g, w, what in zip(got, want, ("extract", "masked", "locals",
                                      "attention")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)
    assert np.abs(got[1] - got[0]).max() > 1e-3  # the masks mattered
    if local:
        assert got[2].shape == (2, 4, 1024) and got[3].shape == (2, 4)


# -- stride placement ---------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stride_on_conv1_block_matches_jax(train):
    """A stride-2 bottleneck with the stride on its first 1x1 (64 -> 128,
    width 32, 9 x 9 input: odd, so the ceil-halving shows)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 9, 64)).astype(np.float32)
    ext = np.array([[9, 5], [7, 9]], np.int32)
    jb = jbackbone.BottleneckBlock(width=32, out_ch=128, stride=2,
                                   stride_on_conv1=True)
    shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 9, 9, 64))))
    variables = _fill_variables(shapes, 3)
    port = BottleneckBlock(64, 32, 128, stride=2, stride_on_conv1=True)
    sd = {}
    _heads_from_flax(variables["params"], variables["batch_stats"], "", sd)
    missing, unexpected = port.load_state_dict(
        {k.replace("downsample_conv", "downsample.0")
         .replace("downsample_bn", "downsample.1"): v for k, v in sd.items()},
        strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    assert port.conv1.stride == (2, 2) and port.conv2.stride == (1, 1)
    xt = T(x).permute(0, 3, 1, 2)
    if train:
        want, upd = jb.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        got = port.train()(xt).permute(0, 2, 3, 1)
        stats = upd["batch_stats"]
        for bn in ("bn1", "bn2", "bn3", "downsample_bn"):
            mod = getattr(port, bn) if bn != "downsample_bn" \
                else port.downsample[1]
            np.testing.assert_allclose(mod.running_mean.numpy(),
                                       stats[bn]["mean"], atol=1e-5)
            np.testing.assert_allclose(mod.running_var.numpy(),
                                       stats[bn]["var"], atol=1e-5)
    else:
        want = jb.apply(variables, jnp.asarray(x), extents=jnp.asarray(ext))
        with torch.no_grad():
            got = port.eval()(xt, extents=T(ext)).permute(0, 2, 3, 1)
    assert got.shape == (2, 5, 5, 128)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_resnet_taps_and_scratch_strides():
    """``out_stages`` gives a dict of NHWC taps, and a single stage its
    tensor; the scratch dolg's stride-2 blocks stride their first 1x1."""
    net = tmodels.ResNet("resnet18", out_stages=(2, 4, 5)).eval()
    with torch.no_grad():
        taps = net(torch.zeros(1, 64, 64, 3))
    assert {s: tuple(t.shape) for s, t in taps.items()} == {
        2: (1, 16, 16, 64), 4: (1, 4, 4, 256), 5: (1, 2, 2, 512)}
    assert tuple(tmodels.ResNet("resnet18")(torch.zeros(1, 64, 64, 3))
                 .shape) == (1, 2, 2, 512)
    scratch = get_model("dolg_r101_scratch", num_classes=4).backbone
    first = scratch.layer3[0]
    assert (first.conv1.stride, first.conv2.stride) == ((2, 2), (1, 1))
    assert sum(b.fusable for i in range(1, 5)
               for b in getattr(scratch, f"layer{i}")) == 29


# -- converters ---------------------------------------------------------------

_PYCLS_NAMES = {"conv1": "f.a", "bn1": "f.a_bn", "conv2": "f.b",
                "bn2": "f.b_bn", "conv3": "f.c", "bn3": "f.c_bn",
                "downsample.0": "proj", "downsample.1": "bn"}


def _layouts(rng):
    """One resnet101's keys with small random arrays (the converters only
    rename and transpose), in the pycls and the features-Sequential
    layouts, each with a key both converters drop."""
    pycls = {"head.fc.weight": rng.standard_normal((3, 2))}
    features = {"2.unused": rng.standard_normal(2)}
    for k in tmodels.ResNet("resnet101").state_dict():
        if k.endswith("num_batches_tracked"):
            continue
        conv = k.endswith("weight") and ("conv" in k or "downsample.0" in k)
        v = rng.standard_normal((3, 2, 3, 3) if conv else 3)
        head, _, rest = k.partition(".")
        if head in ("conv1", "bn1"):
            pycls[f"stem.{head[:-1]}.{rest}"] = v
            features[f"{'01'[head == 'bn1']}.{rest}"] = v
            continue
        stage = head[len("layer"):]
        j, rest = rest.split(".", 1)
        sub, leaf = rest.rsplit(".", 1)
        pycls[f"s{stage}.b{int(j) + 1}.{_PYCLS_NAMES[sub]}.{leaf}"] = v
        features[f"{int(stage) + 3}.{j}.{rest}"] = v
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return f32(pycls), f32(features)


@pytest.mark.parametrize("layout", ["pycls", "features"])
def test_converters_equal_jax(layout):
    pycls, features = _layouts(np.random.default_rng(4))
    if layout == "pycls":
        got = load_pycls_resnet({k: T(v) for k, v in pycls.items()})
        want = from_jax_variables(jbackbone.convert_pycls_resnet(
            pycls, "resnet101"))
    else:
        sd = features
        got = load_features_resnet({k: T(v) for k, v in sd.items()})
        want = from_jax_variables(jbackbone.convert_features_resnet(
            sd, "resnet101"))
    assert set(got) == set(want)
    assert len(got) == 5 + 3 * 33 * 5 + 4 * 5
    for k in want:
        assert torch.equal(got[k], want[k]), k
    port = get_model("dolg_r101_scratch", num_classes=4).backbone
    expected = {k for k in port.state_dict() if "num_batches" not in k}
    assert set(got) == expected


# -- ops ------------------------------------------------------------------------

def test_pooling_and_masking_ops_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)
    ext = np.array([[5, 6], [2, 3], [1, 1]], np.int32)
    mask = np.array(jmasking.hw_mask(5, 6, jnp.asarray(ext)))
    for name in ("avg_pool_all", "max_pool_all", "spoc_pool"):
        jf, tf = getattr(jpooling, name), getattr(tpooling, name)
        for m in (None, mask):
            want = np.asarray(jf(jnp.asarray(x), valid_hw=None if m is None
                                 else jnp.asarray(m)))
            got = tf(T(x), valid_hw=None if m is None else T(m)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=f"{name} mask={m is not None}")
    tm = tmasking.token_mask(5, 6, T(ext))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(
        jmasking.token_mask(5, 6, jnp.asarray(ext))))
    logits = rng.standard_normal((3, 4, 30)).astype(np.float32)
    keys = tm.numpy().copy()
    keys[2] = 0.0  # a row of padding only: finite, uniform after softmax
    want = np.asarray(jmasking.mask_attn_logits(jnp.asarray(logits),
                                                jnp.asarray(keys)))
    got = tmasking.mask_attn_logits(T(logits), T(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    soft = torch.softmax(got, -1)
    assert torch.isfinite(soft).all()
    np.testing.assert_allclose(soft[2].numpy(), 1.0 / 30, atol=1e-6)
    np.testing.assert_allclose(soft.numpy(), np.asarray(
        jax.nn.softmax(jnp.asarray(want), -1)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("s, m, t", [(64.0, 0.5, 0.0), (30.0, 0.15, 0.3)])
def test_arcface_delg_logits_match_jax(s, m, t):
    """Logits / s and the new EMA state; rows 0-1 lie beyond pi - m (the
    linear fallback), and the hard-example rescale is exercised."""
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((6, 8)).astype(np.float32)
    weight = rng.standard_normal((10, 8)).astype(np.float32)
    labels = rng.integers(0, 10, 6)
    for r in (0, 1):
        feats[r] = -weight[labels[r]] + 0.01 * rng.standard_normal(8)
    t_state = np.array([t], np.float32)
    want, want_t = jlosses.arcface_delg_logits(
        jnp.asarray(feats), jnp.asarray(weight), jnp.asarray(labels),
        jnp.asarray(t_state), s=s, m=m)
    got, got_t = tlosses.arcface_delg_logits(T(feats), T(weight), T(labels),
                                             T(t_state), s=s, m=m)
    np.testing.assert_allclose(got.numpy() / s, np.asarray(want) / s,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-6)
    assert got_t.shape == (1,) and not got_t.requires_grad
    cos = (feats / np.linalg.norm(feats, axis=1, keepdims=True)) @ (
        weight / np.linalg.norm(weight, axis=1, keepdims=True)).T
    target = cos[np.arange(6), labels]
    assert (target[:2] < math.cos(math.pi - m)).all()
    margined = target * math.cos(m) - np.sqrt(1 - target ** 2) * math.sin(m)
    assert (cos > margined[:, None]).sum() > 6  # hard examples rescaled


# -- registry and presets -------------------------------------------------------

def test_registry_and_presets_match_jax():
    names = ("gem_r50", "gem_r101", "dolg_r50", "dolg_r101",
             "dolg_r101_scratch", "solar_r50", "solar_r101", "delg_r50",
             "delg_r101", "spca_r50", "spca_r101", "sosnet_r50", "spoc_r50",
             "senet_g2_r50", "adaptive_hybrid_r50", "token_r101",
             "token_r50", "retrievalnet_r101", "how_vlad_r50",
             "how_asmk_r50", "ultron_s", "ultron_b", "vit_s16", "vit_b16",
             "clip_vit_b32", "clip_r50", "spectrum_r50", "iris_r50",
             "sparse_r50", "hamlet_r50")
    assert set(tmodels.list_available_models()) == set(names)
    for n in names:
        assert tmodels.get_model_info(n) == jmodels.get_model_info(n), n
    t1 = {k: v for k, v in jmodels.registry.TABLE1_TO_MODEL_MAPPING.items()
          if v in names}
    assert tmodels.TABLE1_TO_MODEL_MAPPING == t1
    assert "R101-DOLG" in t1
    for t1_name, n in t1.items():
        assert tmodels.get_model_info(t1_name)["name"] == n
    model = get_model("R101-DOLG", backbone_name="resnet18", num_classes=4)
    assert isinstance(model, tmodels.DOLGModel)
    for n in ("dolg_r101", "solar_r101", "delg_r50"):
        got = tconfig.get_preset(n, device="cpu")
        want = jconfig.get_preset(n)
        for f in ("model", "model_overrides", "optimizer", "base_lr",
                  "num_epochs", "batch_size", "imsize"):
            assert getattr(got, f) == getattr(want, f), (n, f)
    jeval, teval = jconfig.EvalConfig(), tconfig.EvalConfig()
    for f in ("local_rerank", "lr_top_attn", "rerank_k", "rerank_blend",
              "rerank_imsize"):
        assert getattr(teval, f) == getattr(jeval, f), f


# -- bf16 -------------------------------------------------------------------------

def test_solar_bf16_extract_matches_jax():
    """The backbone at bf16, the SOA head and GeM in fp32 (flax promotes
    the bf16 map against the head's fp32 parameters): a masked bucket
    against JAX's bf16 extract at 3x its own floor, JAX against itself
    with the input moved by one bf16 ulp."""
    kw = _overrides("solar_r50")
    jm = jmodels.get_model("solar_r50", dtype=BF, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    variables = _fill_variables(shapes, 9)
    port = get_model("solar_r50", dtype="bfloat16", **kw).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ext = np.array([[64, 64], [45, 37]], np.int32)
    x[1, 45:] = 0.0
    x[1, :, 37:] = 0.0
    jext = jax.jit(lambda x: jm.apply(variables, x, jnp.asarray(ext),
                                      method="extract"))
    want = np.asarray(jext(jnp.asarray(x)))
    floor = max(np.abs(np.asarray(jext(jnp.asarray(b))) - want).max()
                for b in bumps(x))
    with torch.no_grad():
        assert port.backbone(T(x[:1])).dtype == torch.bfloat16
        got = port.extract(T(x), T(ext))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 3 * floor, floor
