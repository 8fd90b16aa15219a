"""Plain ViT global descriptor: one image at a time, at its own size.

Architecture (Dosovitskiy et al., "An Image is Worth 16x16 Words", ICLR
2021, arXiv 2010.11929; ViT-B/16: patch 16, width 768, 12 layers, 12
heads of 64, MLP 3072):

* a stride-``patch`` patch projection of the normalized image
  (``(x / 255 - mean) / std``) whose sides are multiples of ``patch``;
* a CLS token; a learned position embedding on the ``img_size /
  patch`` square grid, resized to the image's grid with
  ``resize.triangle_weights`` (bilinear, antialiased when shrinking, as
  ``jax.image.resize``), its CLS entry added to the CLS token;
* pre-norm blocks: ``x + Attn(LN(x))``, then ``x + MLP(LN(x))``; multi-
  head self-attention with biased query / key / value / output
  projections, the query divided by ``sqrt(head_dim)``, softmax over
  the image's own tokens (no padding, no mask); MLP ``dim -> mlp ->
  dim`` with the exact (erf) GELU; a last LN;
* the head (the repository's ViT descriptor, its BASELINE config 3):
  ``whiten(concat(CLS, GeM_p(patch tokens)))`` with GeM ``mean(clamp(x,
  1e-6) ** p) ** (1 / p)``, then L2 (norm clamped at 1e-12);
* multi-scale: for each scale the extents ``floor(side * s)``, the scale
  skipped when a side falls below 36 px, each side then snapped to the
  nearest multiple of ``patch`` (half to even, at least one), the
  normalized image resized once to them with ``resize.triangle_resize``
  (the original size is kept as it is); the kept scales' L2 descriptors
  summed, divided by their count, L2 again.

Departures from the paper, each the repository's model:

* LayerNorm's epsilon is 1e-5 (the paper's code: 1e-6).  Here it is the
  published two-pass form, ``var = mean((x - mean)^2)``; the program
  computes flax's ``max(E[x^2] - E[x]^2, 0)``, which rounds differently;
* the patch projection has no bias (a bias would be a constant added to
  every patch token, that is to the position grid, whose resize keeps
  constants);
* the head above replaces the classifier; the position grid is resized
  to every grid, the native one aside.

Every product (convolution, matrix product, resize) goes through
``precision.py``, so ``precision="tf32"`` is the control; ``fp32`` runs
with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import conv2d, linear, matmul, scope
from perfbench.reference.resize import triangle_resize, triangle_weights

__all__ = ["descriptors", "snap", "task_size"]

_MIN_SIDE = 36


def snap(v: int, multiple: int) -> int:
    """The nearest positive multiple of ``multiple`` to ``v`` (half to
    even), at least one multiple."""
    return max(multiple, int(round(v / multiple)) * multiple)


def task_size(H: int, W: int, s: float, multiple: int):
    """The (h, w) one scale of an ``H`` x ``W`` image is computed at, or
    None where the scale is skipped."""
    h, w = int(math.floor(H * s)), int(math.floor(W * s))
    if h < _MIN_SIDE or w < _MIN_SIDE:
        return None
    return snap(h, multiple), snap(w, multiple)


def _layer_norm(x, w, b, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _position_grid(pos, gh: int, gw: int, native: int, precision: str):
    """``[native^2, C]`` -> ``[gh * gw, C]``: rows, then columns."""
    C = pos.shape[-1]
    wh = torch.as_tensor(triangle_weights(native, gh), dtype=torch.float32,
                         device=pos.device)
    ww = torch.as_tensor(triangle_weights(native, gw), dtype=torch.float32,
                         device=pos.device)
    g = matmul(wh, pos.reshape(native, native * C), precision)
    g = g.reshape(gh, native, C).permute(0, 2, 1)      # [gh, C, native]
    g = matmul(g, ww.t(), precision)                   # [gh, C, gw]
    return g.permute(0, 2, 1).reshape(gh * gw, C)


def _attention(x, p, name, heads: int, precision: str):
    N, C = x.shape
    hd = C // heads

    def proj(leaf):
        y = linear(x, p[f"{name}.{leaf}.weight"],
                   p[f"{name}.{leaf}.bias"].reshape(-1), precision)
        return y.reshape(N, heads, hd).transpose(0, 1)  # [heads, N, hd]

    q = proj("query") / math.sqrt(hd)
    att = torch.softmax(matmul(q, proj("key").transpose(1, 2), precision),
                        dim=-1)
    out = matmul(att, proj("value"), precision).transpose(0, 1)
    return linear(out.reshape(N, C), p[f"{name}.out.weight"],
                  p[f"{name}.out.bias"], precision)


def _descriptor(x, p, cfg: dict, precision: str):
    """One normalized ``[h, w, 3]`` image -> its whitened descriptor."""
    P, eps = cfg["patch"], cfg["ln_eps"]
    h, w = x.shape[:2]
    if h % P or w % P:
        raise ValueError(f"{h}x{w} is not a multiple of the patch {P}")
    gh, gw = h // P, w // P
    native = cfg["img_size"] // P
    y = conv2d(x.permute(2, 0, 1)[None], p["backbone.patch_embed.weight"],
               precision, stride=P)[0]                 # [C, gh, gw]
    y = y.reshape(cfg["dim"], gh * gw).t()
    pos = p["backbone.pos_embed"][0]
    y = y + _position_grid(pos[1:], gh, gw, native, precision)
    cls = p["backbone.cls_token"][0] + pos[:1]
    y = torch.cat([cls, y], dim=0)
    for i in range(cfg["depth"]):
        b = f"backbone.block{i}"
        y = y + _attention(_layer_norm(y, p[b + ".ln1.weight"],
                                       p[b + ".ln1.bias"], eps),
                           p, b + ".attn", cfg["heads"], precision)
        t = linear(_layer_norm(y, p[b + ".ln2.weight"], p[b + ".ln2.bias"],
                               eps),
                   p[b + ".mlp_fc1.weight"], p[b + ".mlp_fc1.bias"],
                   precision)
        y = y + linear(F.gelu(t, approximate="none"),
                       p[b + ".mlp_fc2.weight"], p[b + ".mlp_fc2.bias"],
                       precision)
    y = _layer_norm(y, p["backbone.ln_post.weight"],
                    p["backbone.ln_post.bias"], eps)
    q = cfg["gem_p"]
    gem = torch.clamp(y[1:], min=1e-6).pow(q).mean(0).pow(1.0 / q)
    return linear(torch.cat([y[0], gem])[None], p["whiten.weight"],
                  p["whiten.bias"], precision)[0]


def _l2(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


@torch.no_grad()
def descriptors(images, params: dict, cfg: dict, scales, mean, std,
                device, precision: str = "fp32") -> np.ndarray:
    """``[N, D]`` multi-scale descriptors of raw uint8 ``[h, w, 3]``
    images, each computed alone at its own snapped size per scale."""
    out = np.zeros((len(images), cfg["outputdim"]), np.float32)
    m = torch.tensor(mean, dtype=torch.float32, device=device)
    s = torch.tensor(std, dtype=torch.float32, device=device)
    with scope(precision):
        for i, img in enumerate(images):
            H, W = img.shape[:2]
            x = (torch.as_tensor(img, device=device).to(torch.float32)
                 / 255.0 - m) / s
            acc, kept = 0, 0
            for sc in scales:
                hw = task_size(H, W, sc, cfg["patch"])
                if hw is None:
                    continue
                xs = x if hw == (H, W) else triangle_resize(
                    x[None], *hw, precision)[0]
                acc = acc + _l2(_descriptor(xs, params, cfg, precision))
                kept += 1
            out[i] = _l2(acc / kept).cpu().numpy()
    return out
