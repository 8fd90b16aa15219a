"""Inference stride-1 identity bottleneck with folded batch norm.

Port of ``research_image_retrieval_tpu/ops/resblock_pallas.py``.  On a
CUDA tensor ``fused_bottleneck`` launches the hand-written kernel chain of
``csrc/bottleneck.cu``; on a CPU tensor it computes the same function with
``fused_bottleneck_reference``, its plain PyTorch version.  Both take
optional per-image ``extents`` and then zero conv1's output outside each
image's valid region, as the JAX ``BottleneckBlock`` does on masked
buckets, so the kernel can serve the bucketed main path.

Like the TPU kernel, it computes in the dtype of ``x``: fp32 or bf16.
At fp32 the kernel takes its products on the tensor cores as three TF32
products each (3xTF32: fp32-accurate, never plain TF32) and reads the
(big, small) TF32 split of each conv weight in K-major layout
(``split_weights``).  At bf16 it multiplies bf16 values with fp32
accumulation, applies the folded BN and the residual in fp32 and rounds
t1, t2 and the output to bf16, the rounding points of the TPU kernel at
``dt = bf16``; it reads each weight rounded to bf16 in K-major layout
(``bf16_weights``).  The wrapper makes either form from the fp32 weights
it is given and keeps it while those tensors live unchanged, so a caller
that reuses its weights, as the model's blocks do, converts them once.

The fp32 form's three launches run a persistent stream-K schedule of
128-row tiles (``csrc/stream_k.h``, the note in ``csrc/bottleneck.cu``):
at most one CTA per SM; the tiles of a partial last wave, with the last
whole wave where there is one, are split along K evenly over the CTAs
(none taking fewer than 4 stages of 32), the other whole waves stay
whole, so no SM idles through the tail, and each CTA's ring runs on
from one tile into the next.  The CTA holding a split
tile's first stage waits for the later shares (CTAs of higher index
only, all resident, as the grid never exceeds the SM count), adds them
in K order and runs the epilogue: deterministic, no atomics, the same
products.  BM stays 128: balancing the SMs replaces the 64-row tiles a
partial wave once called for.  The shares pass through a workspace of
one 128 x 128 fp32 slot and one flag per SM, kept per device and stream
(``_workspace``).  ``fused_bottleneck.tiles`` and ``.split_tiles`` count
the output tiles of the fp32 launches and those split along K;
``.last_plan`` holds the last fp32 call's (CTAs, whole tiles, split
tiles) of each of its three launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.ops import _cuda
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["bf16_weights", "fold_bn", "fused_bottleneck",
           "fused_bottleneck_reference", "split_weights"]

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
_ARGTYPES_FP32 = _ARGTYPES + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p]  # ws, flags, slots, plan
_TILE_FLOATS = 128 * 128  # one workspace slot: a 128 x 128 fp32 tile


@functools.cache
def _lib(symbol: str = "rir_fused_bottleneck"):
    fn = getattr(_cuda.library("bottleneck"), symbol)
    fn.argtypes = (_ARGTYPES_FP32 if symbol == "rir_fused_bottleneck"
                   else _ARGTYPES) + [ctypes.c_void_p]  # stream
    fn.restype = ctypes.c_int
    return fn


_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int):
    """The fp32 form's stream-K workspace on ``dev`` for ``stream``: one
    128 x 128 fp32 slot and one int32 flag per SM.  Kept for the process,
    one per (device, stream), since the kernel leaves its flags at 0 and
    two streams must not share them."""
    key = (dev.index, stream)
    hit = _WORKSPACES.get(key)
    if hit is None:
        slots = torch.cuda.get_device_properties(dev).multi_processor_count
        hit = _WORKSPACES[key] = (
            torch.empty(slots * _TILE_FLOATS, dtype=torch.float32, device=dev),
            torch.zeros(slots, dtype=torch.int32, device=dev))
    return hit


def fold_bn(scale, bias, mean, var, eps: float = 1e-5) -> torch.Tensor:
    """BN inference stats as a per-channel affine: [2, C] fp32 (s; b) with
    ``(x - mean) / sqrt(var + eps) * scale + bias == x * s + b``."""
    s = scale / torch.sqrt(var + eps)
    b = bias - mean * s
    return torch.stack([s, b]).to(torch.float32)


def _round_tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), the 13 low bits zeroed."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(w_nk: torch.Tensor) -> torch.Tensor:
    big = _round_tf32(w_nk)
    return torch.stack([big, _round_tf32(w_nk - big)]).contiguous()


@torch.no_grad()
def split_weights(w1, w2, w3):
    """The kernel's weights: for w1 [C, Cw], w2 [3, 3, Cw, Cw] (HWIO) and
    w3 [Cw, C], the (big, small) TF32 split of each in K-major layout:
    [2, Cw, C], [2, Cw, 9 * Cw] (K ordered (dy, dx, ci)) and [2, C, Cw]."""
    cw = w2.shape[3]
    return (_split(w1.t()), _split(w2.permute(3, 0, 1, 2).reshape(cw, -1)),
            _split(w3.t()))


@torch.no_grad()
def bf16_weights(w1, w2, w3):
    """The bf16 kernel's weights: w1, w2 (HWIO), w3 rounded to bf16 in
    K-major layout: [Cw, C], [Cw, 9 * Cw] (K ordered (dy, dx, ci)) and
    [C, Cw]."""
    cw = w2.shape[3]
    return tuple(w.to(torch.bfloat16).contiguous() for w in (
        w1.t(), w2.permute(3, 0, 1, 2).reshape(cw, -1), w3.t()))


_SPLITS: collections.OrderedDict = collections.OrderedDict()
_SPLITS_KEPT = 72  # weight sets x forms; R101 has 29 identity blocks


def _split_of(w1, w2, w3, dtype=torch.float32):
    """The kernel's form of (w1, w2, w3) for activations of ``dtype``
    (``split_weights`` for fp32, ``bf16_weights`` for bf16), made once per
    set of weight tensors and form.

    An entry holds its three tensors, so no other tensor can take their
    ids while it is kept, and their in-place versions, so an in-place
    change (``copy_``, an optimizer step) makes the form anew."""
    key = (id(w1), id(w2), id(w3), dtype)
    versions = (w1._version, w2._version, w3._version)
    hit = _SPLITS.get(key)
    if hit is not None and hit[1] == versions:
        _SPLITS.move_to_end(key)
        return hit[2]
    make = split_weights if dtype == torch.float32 else bf16_weights
    split = make(w1, w2, w3)
    _SPLITS[key] = ((w1, w2, w3), versions, split)
    _SPLITS.move_to_end(key)
    while len(_SPLITS) > _SPLITS_KEPT:
        _SPLITS.popitem(last=False)
    return split


@fp32_precision()
def fused_bottleneck_reference(x, w1, sb1, w2, sb2, w3, sb3, extents=None):
    """Plain version.  x: [B, H, W, C] NHWC, fp32 or bf16; w1 [C, Cw]; w2
    [3, 3, Cw, Cw] HWIO; w3 [Cw, C]; sb* [2, C'] fp32 from ``fold_bn``;
    extents [B, 2] or None.

    In the dtype of ``x``, as the JAX ``fused_bottleneck_reference``: at
    bf16 the weights are rounded to bf16, the products of the bf16 values
    are summed in fp32, the affines and the residual are fp32, and t1, t2
    and the output are rounded to bf16.
    """
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)  # float64 stays float64
    w1, w2, w3 = (w.to(dt).to(ct) for w in (w1, w2, w3))
    xf = x.to(ct)
    t = torch.relu((xf @ w1) * sb1[0] + sb1[1]).to(dt)
    if extents is not None:
        t = t * hw_mask(x.shape[1], x.shape[2], extents, dtype=t.dtype)[..., None]
    t = F.conv2d(t.to(ct).permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                 padding=1)
    t = torch.relu(t.permute(0, 2, 3, 1) * sb2[0] + sb2[1]).to(dt)
    y = (t.to(ct) @ w3) * sb3[0] + sb3[1] + xf
    return torch.relu(y).to(dt)


def _check(name, t, device, shape, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != (torch.int32 if name == "extents" else dtype):
        raise ValueError(f"{name} has dtype {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_bottleneck(x: torch.Tensor, w1, sb1, w2, sb2, w3, sb3,
                     extents: torch.Tensor | None = None) -> torch.Tensor:
    """Fused stride-1 identity-skip bottleneck, [B, H, W, C] -> same.

    Args as ``fused_bottleneck_reference``.  On CUDA: x fp32 or bf16 (the
    kernel's form follows it; any other dtype raises), fp32 weights and
    affines, C and Cw multiples of 64 (every ResNet bottleneck), all
    operands contiguous on x's device; the weights' form for x's dtype is
    made on the first call with these weight tensors and kept
    (``_split_of``).  A failed launch raises.
    """
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, sb1, w2, sb2, w3, sb3,
                                          extents=extents)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    Cw = w1.shape[1]
    if C % 64 or Cw % 64:
        raise ValueError(f"C={C} and Cw={Cw} must be multiples of 64")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x has dtype {dt}; the kernel takes fp32 or bf16")
    dev = x.device
    _check("x", x, dev, (B, H, W, C), dt)
    _check("w1", w1, dev, (C, Cw))
    _check("sb1", sb1, dev, (2, Cw))
    _check("w2", w2, dev, (3, 3, Cw, Cw))
    _check("sb2", sb2, dev, (2, Cw))
    _check("w3", w3, dev, (Cw, C))
    _check("sb3", sb3, dev, (2, C))
    k1, k2, k3 = _split_of(w1, w2, w3, dt)
    ext = None
    if extents is not None:
        ext = extents.to(torch.int32).contiguous()
        _check("extents", ext, dev, (B, 2))
    t1 = torch.empty((B, H, W, Cw), dtype=dt, device=dev)
    t2 = torch.empty_like(t1)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [x.data_ptr(), k1.data_ptr(), sb1.data_ptr(), k2.data_ptr(),
            sb2.data_ptr(), k3.data_ptr(), sb3.data_ptr(),
            None if ext is None else ext.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), out.data_ptr(), B, H, W, C, Cw]
    if dt == torch.float32:
        ws, flags = _workspace(dev, stream)
        plan = (ctypes.c_int * 9)()
        rc = _lib("rir_fused_bottleneck")(
            *args, ws.data_ptr(), flags.data_ptr(), flags.numel(),
            ctypes.addressof(plan), stream)
    else:
        rc = _lib("rir_fused_bottleneck_bf16")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"bottleneck kernel launch failed: cudaError {rc}")
    fused_bottleneck.launches += 1
    if dt == torch.float32:
        fused_bottleneck.last_plan = [tuple(plan[i:i + 3]) for i in (0, 3, 6)]
        fused_bottleneck.tiles += plan[1] + plan[2] + plan[4] + plan[5] \
            + plan[7] + plan[8]
        fused_bottleneck.split_tiles += plan[2] + plan[5] + plan[8]
    return out


fused_bottleneck.launches = 0
fused_bottleneck.tiles = 0
fused_bottleneck.split_tiles = 0
fused_bottleneck.last_plan = []
