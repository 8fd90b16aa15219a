"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels build from
``research_image_retrieval_tpu_torch/csrc`` at first use) and skips
without one.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: the head is fp32 FMA on both sides, sums in another order,
and holds to rtol 1e-5 / atol 1e-6 (bf16 weight: 5e-3, the Pallas bar);
the bottleneck's 3xTF32 products carry fp32's accuracy and hold to atol
1e-4 on O(1) outputs, whether or not its schedule splits a tile's K.
"""

import math

import pytest
import torch

from research_image_retrieval_tpu_torch.ops import gem_head, resblock

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("form", ["none", "extents", "mask"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_gem_head_kernel(cuda, form, wdt):
    g = cuda
    B, H, W, C, D = 3, 9, 7, 256, 96
    fmap = torch.randn(B, H, W, C, device="cuda", generator=g).abs()
    weight = torch.randn(D, C, device="cuda", generator=g) / math.sqrt(C)
    bias = 0.01 * torch.randn(D, device="cuda", generator=g)
    kw = {}
    if form == "extents":
        kw["extents"] = torch.tensor([[9, 7], [4, 3], [1, 7]], device="cuda",
                                     dtype=torch.int32)
    elif form == "mask":
        kw["valid_hw"] = (torch.rand(B, H, W, device="cuda", generator=g)
                          > 0.5).float()
    before = gem_head.gem_whiten_l2.launches
    got = gem_head.gem_whiten_l2(fmap, weight, bias, weight_dtype=wdt, **kw)
    want = gem_head.gem_whiten_l2_reference(fmap, weight, bias,
                                            weight_dtype=wdt, **kw)
    torch.cuda.synchronize()
    assert gem_head.gem_whiten_l2.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("side", [32, 16])
def test_gem_head_kernel_device_p(cuda, B, side):
    """The main path's head shapes (layer4 of the 1024 and 512 px
    buckets, 2048 -> 2048) with p as a tensor on the card, as a learnable
    p is passed: read there, never copied to the host."""
    g = cuda
    C = D = 2048
    fmap = torch.randn(B, side, side, C, device="cuda", generator=g).abs()
    weight = torch.randn(D, C, device="cuda", generator=g) / math.sqrt(C)
    bias = 0.01 * torch.randn(D, device="cuda", generator=g)
    ext = torch.randint(1, side + 1, (B, 2), device="cuda", generator=g,
                        dtype=torch.int32)
    p = torch.tensor([2.5], device="cuda")
    before = gem_head.gem_whiten_l2.launches
    got = gem_head.gem_whiten_l2(fmap, weight, bias, p=p, extents=ext,
                                 weight_dtype=torch.float32)
    want = gem_head.gem_whiten_l2_reference(fmap, weight, bias, p=p,
                                            extents=ext,
                                            weight_dtype=torch.float32)
    torch.cuda.synchronize()
    assert gem_head.gem_whiten_l2.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["extents", "mask"])
def test_gem_head_kernel_large_map(cuda, form):
    """A map larger than any main-path one (48 x 48 cells): each pool
    block walks all of an image's valid cells, however many."""
    g = cuda
    B, side, C, D = 2, 48, 512, 256
    fmap = torch.randn(B, side, side, C, device="cuda", generator=g).abs()
    weight = torch.randn(D, C, device="cuda", generator=g) / math.sqrt(C)
    bias = 0.01 * torch.randn(D, device="cuda", generator=g)
    kw = ({"extents": torch.tensor([[48, 48], [30, 41]], device="cuda",
                                   dtype=torch.int32)}
          if form == "extents" else
          {"valid_hw": (torch.rand(B, side, side, device="cuda", generator=g)
                        > 0.5).float()})
    before = gem_head.gem_whiten_l2.launches
    got = gem_head.gem_whiten_l2(fmap, weight, bias,
                                 weight_dtype=torch.float32, **kw)
    want = gem_head.gem_whiten_l2_reference(fmap, weight, bias,
                                            weight_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert gem_head.gem_whiten_l2.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _bottleneck_inputs(g, B, h, w, c, cw, with_extents):
    rn = lambda *s, scale=1.0: torch.randn(*s, device="cuda",
                                           generator=g) * scale

    def sb(n):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, device="cuda",
                                                       generator=g)
        return resblock.fold_bn(u(0.5, 1.5), u(-0.2, 0.2), u(-0.1, 0.1),
                                u(0.5, 2.0)).contiguous()

    x = rn(B, h, w, c, scale=0.5)
    ws = (rn(c, cw, scale=c ** -0.5), sb(cw),
          rn(3, 3, cw, cw, scale=(9 * cw) ** -0.5), sb(cw),
          rn(cw, c, scale=cw ** -0.5), sb(c))
    ext = (torch.tensor([[h, w]] + [[h // 2 + 1, w - 3]] * (B - 1),
                        device="cuda", dtype=torch.int32)
           if with_extents else None)
    return x, ws, ext


@pytest.mark.parametrize("with_extents", [False, True])
@pytest.mark.parametrize("c,cw,h,w", [(256, 64, 19, 13), (512, 128, 8, 8)])
def test_bottleneck_kernel(cuda, c, cw, h, w, with_extents):
    x, ws, ext = _bottleneck_inputs(cuda, 2, h, w, c, cw, with_extents)
    got = resblock.fused_bottleneck(x, *ws, extents=ext)
    want = resblock.fused_bottleneck_reference(x, *ws, extents=ext)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


WHOLE_WAVES = object()  # (B, h) = (2, 64) with w = the SM count: 128 * SMs rows


@pytest.mark.parametrize("B,h,w,c,cw,split", [
    (2, 19, 13, 256, 64, None),
    (2, 19, 13, 2048, 512, None),
    (8, 16, 16, 2048, 512, None),
    (8, 24, 24, 1024, 256, True),
    (8, 24, 48, 1024, 256, True),
    (8, 48, 32, 1024, 256, True),
    (1, 32, 24, 2048, 512, True),
    (2, 64, WHOLE_WAVES, 1024, 256, False)])
def test_bottleneck_kernel_tiles(cuda, B, h, w, c, cw, split):
    """Shapes that stress the stream-K schedule, with extents, against
    the plain version; two calls on the same inputs equal bit for bit
    (the split tiles' fixup adds the shares in a fixed order).  M = 494
    (not a multiple of a tile) at the narrowest and the widest block; M =
    2048 at C = 2048 (layer4 of the 512 px bucket); the index cell's
    layer 3 at M = 4608, 9216 and 12288 (partial waves: tiles split along
    K); layer 4 at B = 1, as ``cli.serve`` runs it (6 row tiles); and 128
    rows per SM at layer 3, whole waves of tiles in all three launches
    (nothing split)."""
    if w is WHOLE_WAVES:
        w = torch.cuda.get_device_properties(0).multi_processor_count
    x, ws, ext = _bottleneck_inputs(cuda, B, h, w, c, cw, True)
    fb = resblock.fused_bottleneck
    before = (fb.launches, fb.tiles, fb.split_tiles)
    got = fb(x, *ws, extents=ext)
    plan = fb.last_plan
    again = fb(x, *ws, extents=ext)
    want = resblock.fused_bottleneck_reference(x, *ws, extents=ext)
    torch.cuda.synchronize()
    assert fb.launches == before[0] + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)
    split_tiles = fb.split_tiles - before[2]
    assert fb.tiles - before[1] == 2 * sum(whole + sp for _, whole, sp in plan)
    assert split_tiles == 2 * sum(sp for _, _, sp in plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert all(1 <= ctas <= sms for ctas, _, _ in plan)
    if split is True:
        assert split_tiles > 0, plan
    elif split is False:
        assert split_tiles == 0, plan


def test_bottleneck_kernel_weights_changed_in_place(cuda):
    """The kernel's kept weight split follows an in-place change of the
    weights it was made from."""
    x, ws, ext = _bottleneck_inputs(cuda, 2, 8, 8, 256, 64, True)
    resblock.fused_bottleneck(x, *ws, extents=ext)
    with torch.no_grad():
        ws[2].mul_(-0.5)
    got = resblock.fused_bottleneck(x, *ws, extents=ext)
    want = resblock.fused_bottleneck_reference(x, *ws, extents=ext)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_bottleneck_kernel_rejects_bad_width(cuda):
    x = torch.zeros(1, 4, 4, 96, device="cuda")
    w = torch.zeros(96, 24, device="cuda")
    with pytest.raises(ValueError):
        resblock.fused_bottleneck(x, w, None, None, None, None, None)
