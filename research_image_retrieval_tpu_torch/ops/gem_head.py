"""GeM pooling + whiten projection + L2 norm: the descriptor head.

Port of ``research_image_retrieval_tpu/ops/gem_pallas.py``.  On a CUDA
tensor ``gem_whiten_l2`` launches the hand-written kernel of
``csrc/gem_head.cu``; on a CPU tensor it computes the same function with
``gem_whiten_l2_reference``, its plain PyTorch version.  The map may be
fp32 or bf16 (a bf16 model's layer4 output); either way it is pooled in
fp32, as the TPU kernel upcasts its block.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from research_image_retrieval_tpu_torch.ops import _cuda
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["gem_whiten_l2", "gem_whiten_l2_reference"]

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_void_p])


@functools.cache
def _lib():
    fn = _cuda.library("gem_head").rir_gem_whiten_l2
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _proj_slices(C: int) -> int:
    """Channel slices of the projection launch: up to 4 of >= 512
    channels (at C = D = 2048, 256 blocks instead of 64)."""
    return max(1, min(4, C // 512))


@functools.lru_cache(maxsize=8)
def _p_on(p: float, device: torch.device) -> torch.Tensor:
    """A float ``p`` as the one-element device tensor the kernel reads,
    made once per value and device (never written)."""
    return torch.full((1,), p, dtype=torch.float32, device=device)


@fp32_precision()
def gem_whiten_l2_reference(fmap, weight, bias, p=3.0, eps=1e-6,
                            valid_hw=None, extents=None,
                            weight_dtype=torch.float32):
    """Plain version: gem_pool (fp32, of an fp32 or bf16 map) ->
    ``pooled @ weight.T + bias`` -> L2.

    The weight is rounded to ``weight_dtype`` and read back as fp32, the
    same numerics as the kernel (fp32 accumulation either way).
    """
    if extents is not None:
        valid_hw = hw_mask(fmap.shape[1], fmap.shape[2], extents)
    pooled = gem_pool(fmap, p=p, eps=eps, valid_hw=valid_hw)
    w = weight.to(weight_dtype).to(torch.float32)
    y = pooled @ w.T + bias.to(torch.float32)
    return l2_normalize(y, dim=-1)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, fmap on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def gem_whiten_l2(fmap: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, p=3.0, eps: float = 1e-6,
                  valid_hw: torch.Tensor | None = None,
                  extents: torch.Tensor | None = None,
                  weight_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused descriptor head.

    Args:
      fmap: [B, H, W, C] fp32 or bf16 feature map (NHWC, contiguous);
        any other dtype raises on CUDA.
      weight: [D, C] whiten projection (``nn.Linear.weight`` layout),
        read as ``weight_dtype`` (bf16 by default, as the TPU kernel;
        the main path's ``extract`` passes float32), fp32 accumulation.
      bias: [D].
      p: GeM power, a float or a one-element tensor (on CUDA the kernel
        reads it from device memory: a learnable p is never copied to
        the host).
      valid_hw: optional [B, H, W] bucket mask; or
      extents: optional [B, 2] int valid (rows, cols) at fmap resolution.

    Returns:
      [B, D] L2-normalized fp32 descriptors.
    """
    if fmap.device.type == "cpu":
        return gem_whiten_l2_reference(fmap, weight, bias, p=p, eps=eps,
                                       valid_hw=valid_hw, extents=extents,
                                       weight_dtype=weight_dtype)
    if fmap.device.type != "cuda":
        raise ValueError(f"gem_whiten_l2: unsupported device {fmap.device}")
    if valid_hw is not None and extents is not None:
        raise ValueError("pass valid_hw or extents, not both")
    if fmap.dim() != 4:
        raise ValueError(f"fmap must be [B, H, W, C], got {tuple(fmap.shape)}")
    B, H, W, C = fmap.shape
    D = weight.shape[0]
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype must be float32 or bfloat16, "
                         f"got {weight_dtype}")
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fmap has dtype {fmap.dtype}; the kernel reads "
                         "fp32 or bf16 maps")
    # 16-byte loads of weight rows and map pixels
    vec = 8 if torch.bfloat16 in (weight_dtype, fmap.dtype) else 4
    if C % vec:
        raise ValueError(f"C={C} must be a multiple of {vec} for a "
                         f"{fmap.dtype} map and a {weight_dtype} weight")
    dev = fmap.device
    w = weight.detach().to(weight_dtype).contiguous()
    b = bias.detach().to(torch.float32).contiguous()
    _check("fmap", fmap, dev, fmap.dtype, (B, H, W, C))
    _check("weight", w, dev, weight_dtype, (D, C))
    _check("bias", b, dev, torch.float32, (D,))
    ext = mask = None
    if extents is not None:
        ext = extents.to(torch.int32).contiguous()
        _check("extents", ext, dev, torch.int32, (B, 2))
    if valid_hw is not None:
        mask = valid_hw.to(torch.float32).contiguous()
        _check("valid_hw", mask, dev, torch.float32, (B, H, W))
    if isinstance(p, torch.Tensor):
        if p.numel() != 1:
            raise ValueError(f"p must have one element, got {tuple(p.shape)}")
        pt = p.detach().to(device=dev, dtype=torch.float32).reshape(1)
        _check("p", pt, dev, torch.float32, (1,))
    else:
        pt = _p_on(float(p), dev)
    ks = _proj_slices(C)
    # scratch: pooled [B, C], then ypart [ks, B, D] (16-byte aligned: C % 4 == 0)
    work = torch.empty(B * C + ks * B * D, dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _lib()(fmap.data_ptr(), ptr(ext), ptr(mask), pt.data_ptr(),
                w.data_ptr(), b.data_ptr(), work.data_ptr(),
                work.data_ptr() + 4 * B * C, out.data_ptr(),
                int(weight_dtype == torch.bfloat16),
                int(fmap.dtype == torch.bfloat16), B, H, W, C, D, ks, eps,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gem_head kernel launch failed: cudaError {rc}")
    gem_whiten_l2.launches += 1
    return out


gem_whiten_l2.launches = 0
