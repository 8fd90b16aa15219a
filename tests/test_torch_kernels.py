"""PyTorch port, the two kernel modules on the CPU: each plain version
(what the wrapper computes for a CPU tensor) against the JAX Pallas kernel
run as the JAX package's own tests run it, in interpret mode.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from research_image_retrieval_tpu.models.backbone import (
    BottleneckBlock as JaxBottleneck,
)
from research_image_retrieval_tpu.ops.gem_pallas import (
    gem_whiten_l2_reference as jax_gem_reference,
)
from research_image_retrieval_tpu.ops.gem_pallas import pallas_gem_whiten_l2
from research_image_retrieval_tpu.ops.resblock_pallas import (
    fold_bn as jax_fold_bn,
)
from research_image_retrieval_tpu.ops.resblock_pallas import (
    pallas_fused_bottleneck,
)
from research_image_retrieval_tpu_torch.models.backbone import BottleneckBlock
from research_image_retrieval_tpu_torch.ops import gem_head, resblock
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy


# -- kernel 1: GeM + whiten + L2 (the five cases of test_gem_pallas.py) ----

def _gem_setup(rng, B=2, H=7, W=9, C=32, D=16):
    fmap = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((C, D)) * 0.1).astype(np.float32)  # JAX [C, D]
    b = (rng.standard_normal(D) * 0.01).astype(np.float32)
    return fmap, w, b


def _port_gem(fmap, w, b, **kw):
    # the port takes the nn.Linear layout [D, C]
    return gem_head.gem_whiten_l2(T(fmap), T(np.ascontiguousarray(w.T)),
                                  T(b), **kw).numpy()


def test_gem_matches_pallas(rng):
    fmap, w, b = _gem_setup(rng)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gem_whiten_l2(jnp.asarray(fmap), jnp.asarray(w),
                                    jnp.asarray(b), p=3.0, block=16,
                                    weight_dtype="float32")
    got = _port_gem(fmap, w, b, p=3.0, weight_dtype=torch.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_gem_hw_not_multiple_of_block(rng):
    fmap, w, b = _gem_setup(rng, H=5, W=5)  # 25 cells, Pallas block 16
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gem_whiten_l2(jnp.asarray(fmap), jnp.asarray(w),
                                    jnp.asarray(b), block=16,
                                    weight_dtype="float32")
    got = _port_gem(fmap, w, b, weight_dtype=torch.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["mask", "extents"])
def test_gem_masked_bucket(rng, form):
    """A masked padded bucket equals pooling the crop, for the dense mask
    and for the [B, 2] extents form the port's model passes."""
    fmap, w, b = _gem_setup(rng, B=1, H=8, W=8)
    mask = np.zeros((1, 8, 8), np.float32)
    mask[:, :5, :6] = 1.0
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gem_whiten_l2(jnp.asarray(fmap), jnp.asarray(w),
                                    jnp.asarray(b), valid_hw=jnp.asarray(mask),
                                    block=16, weight_dtype="float32")
    crop = _port_gem(np.ascontiguousarray(fmap[:, :5, :6]), w, b,
                     weight_dtype=torch.float32)
    kw = ({"valid_hw": T(mask)} if form == "mask"
          else {"extents": torch.tensor([[5, 6]], dtype=torch.int32)})
    got = _port_gem(fmap, w, b, weight_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, crop, rtol=1e-5, atol=1e-6)


def test_gem_unit_norm(rng):
    fmap, w, b = _gem_setup(rng, B=3)
    got = _port_gem(fmap, w, b)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def test_gem_bf16_weight_tolerance(rng):
    """bf16 weight (the default): the Pallas kernel's numerics, within
    5e-3 of the fp32 reference."""
    fmap, w, b = _gem_setup(rng)
    with pltpu.force_tpu_interpret_mode():
        pallas = pallas_gem_whiten_l2(jnp.asarray(fmap), jnp.asarray(w),
                                      jnp.asarray(b), block=16)
    want = jax_gem_reference(jnp.asarray(fmap), jnp.asarray(w), jnp.asarray(b))
    got = _port_gem(fmap, w, b)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-3)
    # same bf16 rounding of the weight as the Pallas kernel
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-6)


def test_gem_rejects_other_devices(rng):
    """No silent fallback: only CPU tensors take the plain version."""
    fmap, w, b = _gem_setup(rng)
    with pytest.raises(ValueError):
        gem_head.gem_whiten_l2(T(fmap).to("meta"), T(w.T.copy()), T(b))


# -- kernel 2: fused stride-1 bottleneck ---------------------------------

def _block_weights(rng, c, cw):
    w1 = (rng.standard_normal((c, cw)) * c ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, cw, cw)) * (9 * cw) ** -0.5).astype(
        np.float32)
    w3 = (rng.standard_normal((cw, c)) * cw ** -0.5).astype(np.float32)

    def bn(n):
        return [rng.uniform(lo, hi, n).astype(np.float32)
                for lo, hi in ((0.5, 1.5), (-0.2, 0.2), (-0.1, 0.1),
                               (0.5, 2.0))]

    return w1, bn(cw), w2, bn(cw), w3, bn(c)


def _fold_both(ws):
    w1, bn1, w2, bn2, w3, bn3 = ws
    jx = (jnp.asarray(w1), jax_fold_bn(*map(jnp.asarray, bn1)),
          jnp.asarray(w2), jax_fold_bn(*map(jnp.asarray, bn2)),
          jnp.asarray(w3), jax_fold_bn(*map(jnp.asarray, bn3)))
    pt = (T(w1), resblock.fold_bn(*map(T, bn1)), T(w2),
          resblock.fold_bn(*map(T, bn2)), T(w3), resblock.fold_bn(*map(T, bn3)))
    return jx, pt


@pytest.mark.parametrize("height", [19, 16, 7])
def test_bottleneck_matches_pallas(rng, height):
    """Heights against a tile of 8 (odd rows, height == tile, < tile), as
    tests/test_resblock_pallas.py; 2e-5 as there."""
    x = (rng.standard_normal((2, height, 32, 64)) * 0.5).astype(np.float32)
    jx, pt = _fold_both(_block_weights(rng, 64, 16))
    want = pallas_fused_bottleneck(jnp.asarray(x), *jx, th=8, interpret=True)
    got = resblock.fused_bottleneck(T(x), *pt).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_fold_bn_matches_batchnorm_inference(rng):
    c = 24
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = rng.uniform(0.2, 2.0, c).astype(np.float32)
    x = rng.standard_normal((5, c)).astype(np.float32)
    sb = resblock.fold_bn(T(scale), T(bias), T(mean), T(var), eps=1e-5)
    bn = torch.nn.BatchNorm1d(c, eps=1e-5).eval()
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
        bn.running_mean.copy_(T(mean))
        bn.running_var.copy_(T(var))
        want = bn(T(x)).numpy()
    np.testing.assert_allclose((T(x) * sb[0] + sb[1]).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        sb.numpy(),
        np.asarray(jax_fold_bn(*map(jnp.asarray, (scale, bias, mean, var)))),
        rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_block():
    """A JAX BottleneckBlock (C=64, Cw=16) with random BN stats, and the
    port's BottleneckBlock loaded with the same weights."""
    rng = np.random.default_rng(11)
    blk = JaxBottleneck(width=16, out_ch=64, stride=1)
    v = blk.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 64)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = {k: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(
                     np.float32),
                 "var": (np.abs(rng.standard_normal(s["var"].shape)) + 0.5
                         ).astype(np.float32)}
             for k, s in v["batch_stats"].items()}
    for k in ("bn1", "bn2", "bn3"):
        n = params[k]["bias"].shape
        params[k] = {"scale": (1 + 0.1 * rng.standard_normal(n)).astype(
                         np.float32),
                     "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)}
    port = BottleneckBlock(64, 16, 64, stride=1)
    sd = {}
    for k in (1, 2, 3):
        sd[f"conv{k}.weight"] = T(np.ascontiguousarray(
            np.transpose(params[f"conv{k}"]["kernel"], (3, 2, 0, 1))))
        sd[f"bn{k}.weight"] = T(params[f"bn{k}"]["scale"])
        sd[f"bn{k}.bias"] = T(params[f"bn{k}"]["bias"])
        sd[f"bn{k}.running_mean"] = T(stats[f"bn{k}"]["mean"])
        sd[f"bn{k}.running_var"] = T(stats[f"bn{k}"]["var"])
    port.load_state_dict(sd, strict=False)
    port.eval()
    return blk, {"params": params, "batch_stats": stats}, port


@pytest.mark.parametrize("with_extents", [False, True])
def test_bottleneck_block_matches_jax_block(jax_block, rng, with_extents):
    """The port's block in eval mode (the fused path with extents) equals
    the JAX BottleneckBlock on a masked bucket: 1e-5 (fp32, BN folded)."""
    blk, variables, port = jax_block
    assert port.fusable
    x = rng.standard_normal((2, 11, 13, 64)).astype(np.float32)
    ext = np.array([[11, 13], [7, 5]], np.int32) if with_extents else None
    want = blk.apply(variables, jnp.asarray(x), train=False,
                     extents=None if ext is None else jnp.asarray(ext))
    with torch.no_grad():
        got = port(T(x).permute(0, 3, 1, 2),
                   extents=None if ext is None else T(ext))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bottleneck_extents_zero_conv1_outside(rng):
    """With extents, the padded region of conv1's output is exact zero:
    the block's valid cells equal the block run on the crop."""
    x = rng.standard_normal((1, 12, 10, 64)).astype(np.float32)
    _, pt = _fold_both(_block_weights(rng, 64, 16))
    full = resblock.fused_bottleneck(
        T(x), *pt, extents=torch.tensor([[7, 6]], dtype=torch.int32)).numpy()
    crop = resblock.fused_bottleneck(
        T(np.ascontiguousarray(x[:, :7, :6])), *pt).numpy()
    np.testing.assert_allclose(full[:, :7, :6], crop, rtol=1e-5, atol=1e-6)


# -- the CUDA kernel's numerics: 3xTF32 products, emulated on the CPU ------
#
# The kernel splits each operand v into big = rna_tf32(v) and small =
# rna_tf32(v - big) and sums small*big + big*small + big*big in fp32.
# Products of two TF32 values are exact in fp32, so plain fp32 matmuls of
# the rounded operands give the kernel's numbers up to summation order.

def _tf32(v):
    """Round fp32 to TF32 (nearest, ties away): add 0x1000, mask ~0x1FFF."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b_nk, products):
    """a [M, K] @ b_nk[N, K].T with TF32 operands, in the kernel's order."""
    a_big, b_big = _tf32(a), _tf32(b_nk)
    if products == 1:
        return a_big @ b_big.T
    acc = _tf32(a - a_big) @ b_big.T
    acc = acc + a_big @ _tf32(b_nk - b_big).T
    return acc + a_big @ b_big.T


def _emulated_bottleneck(x, w1, sb1, w2, sb2, w3, sb3, extents, products):
    """The kernel's chain of three implicit GEMMs: K-major weights, conv2
    as im2col over (dy, dx, ci) with zero padding."""
    B, H, W, C = x.shape
    cw = w1.shape[1]
    a = x.reshape(-1, C)
    t1 = torch.relu(_mm_tf32(a, w1.t(), products) * sb1[0] + sb1[1])
    t1 = t1.reshape(B, H, W, cw)
    if extents is not None:
        keep = ((torch.arange(H)[None, :, None] < extents[:, 0, None, None])
                & (torch.arange(W)[None, None, :] < extents[:, 1, None, None]))
        t1 = t1 * keep[..., None]
    tp = torch.nn.functional.pad(t1, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([tp[:, dy:dy + H, dx:dx + W] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(-1, 9 * cw)
    w2_nk = w2.permute(3, 0, 1, 2).reshape(cw, 9 * cw)
    t2 = torch.relu(_mm_tf32(cols, w2_nk, products) * sb2[0] + sb2[1])
    y = _mm_tf32(t2, w3.t(), products) * sb3[0] + sb3[1] + a
    return torch.relu(y).reshape(B, H, W, C)


def _r50_block_inputs(rng, c, cw):
    x = (rng.standard_normal((2, 7, 6, c)) * 0.5).astype(np.float32)
    _, pt = _fold_both(_block_weights(rng, c, cw))
    return T(x), pt, torch.tensor([[7, 6], [5, 3]], dtype=torch.int32)


@pytest.mark.parametrize("c,cw", [(256, 64), (512, 128), (1024, 256),
                                  (2048, 512)])
def test_bottleneck_3xtf32_holds_kernel_bar(rng, c, cw):
    """At the four R50 identity widths, with extents, 3xTF32 products stay
    within the kernel's bar (rtol 1e-5, atol 1e-4) of the fp32 plain
    version, and the port's weight split is this emulation's split."""
    x, pt, ext = _r50_block_inputs(rng, c, cw)
    w1, _, w2, _, w3, _ = pt
    for got, w_nk in zip(resblock.split_weights(w1, w2, w3),
                         (w1.t(), w2.permute(3, 0, 1, 2).reshape(cw, -1),
                          w3.t())):
        big = _tf32(w_nk)
        torch.testing.assert_close(got, torch.stack([big, _tf32(w_nk - big)]),
                                   rtol=0, atol=0)
    want = resblock.fused_bottleneck_reference(x, *pt, extents=ext)
    got = _emulated_bottleneck(x, *pt, ext, products=3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_bottleneck_1xtf32_misses_kernel_bar(rng):
    """Why three products: one TF32 product per fp32 product (K up to
    9 * 512) misses the same bar by an order of magnitude."""
    x, pt, ext = _r50_block_inputs(rng, 2048, 512)
    want = resblock.fused_bottleneck_reference(x, *pt, extents=ext)
    err = (_emulated_bottleneck(x, *pt, ext, products=1) - want).abs()
    assert bool((err > 1e-4 + 1e-5 * want.abs()).any())
    assert err.max().item() > 5e-4


def test_bottleneck_split_kept_per_weight_tensors(rng):
    """The wrapper's kept split is made once per set of weight tensors,
    made anew after an in-place change, and never shared between sets."""
    _, pt = _fold_both(_block_weights(rng, 64, 16))
    w1, _, w2, _, w3, _ = pt
    first = resblock._split_of(w1, w2, w3)
    assert resblock._split_of(w1, w2, w3) is first
    other = resblock._split_of(w1.clone(), w2, w3)
    assert other is not first
    with torch.no_grad():
        w2.mul_(-0.5)
    again = resblock._split_of(w1, w2, w3)
    assert again is not first
    for got, want in zip(again, resblock.split_weights(w1, w2, w3)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bottleneck_rejects_other_devices(rng):
    x = rng.standard_normal((1, 4, 4, 64)).astype(np.float32)
    _, pt = _fold_both(_block_weights(rng, 64, 16))
    with pytest.raises(ValueError):
        resblock.fused_bottleneck(T(x).to("meta"), *pt)
