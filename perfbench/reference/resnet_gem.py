"""Plain ResNet-GeM: the descriptor of one image at its own size, and the
ArcFace training step.

Architecture (He et al., CVPR 2016, torchvision v1.5: the stride on the
3x3; Radenovic et al., TPAMI 2018 for GeM and the whitening; Deng et
al., CVPR 2019 for ArcFace):

* stem: 7x7/2 convolution (padding 3), BN, ReLU, 3x3/2 max pool
  (padding 1); bottleneck stages of ``depths`` blocks, widths 64-512,
  expansion 4, a 1x1 projection skip on each stage's first block;
* GeM: ``mean(clamp(x, 1e-6) ** p) ** (1 / p)`` over the map's cells;
  whitening ``W x + b``; L2 (norm clamped at 1e-12);
* multi-scale: each scale resized with ``resize.triangle_resize`` from
  the normalized image (``(x / 255 - mean) / std``), scales whose side
  falls below 36 px skipped, descriptors summed, divided by the kept
  count, L2 again;
* training: BN on the batch's statistics as flax computes them
  (``var = E[x^2] - E[x]^2``, biased, ``eps = 1e-5``) and running
  averages ``0.9 * running + 0.1 * batch`` of the mean and of that
  biased variance; ArcFace on L2-normalized features and class weights
  (angle clamped to ``[-1 + 1e-6, 1 - 1e-6]`` before ``arccos``, the
  margin added to the target's angle unless it passes ``pi - m``),
  logits times ``s``, mean cross entropy; the update: gradients clipped
  to a global norm of ``clip`` (``g * clip / norm`` where ``norm >=
  clip``), SGD with Nesterov momentum and L2 decay added to the gradient
  of every weight of rank > 1, lr constant.

Extraction computes each image at its own size: no buckets, no masks.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import conv2d, linear, matmul, scope
from perfbench.reference.resize import triangle_resize

__all__ = ["descriptors", "train_steps"]

_EPS_BN = 1e-5
_MIN_SIDE = 36


def _bn_eval(x, p, name):
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(p[name + ".running_var"] + _EPS_BN)
    return ((x - p[name + ".running_mean"].view(shape))
            * (inv * p[name + ".weight"]).view(shape)
            + p[name + ".bias"].view(shape))


class _BatchNormTrain(torch.autograd.Function):
    """flax's train-mode BN of NCHW ``x`` with its analytic backward:
    ``dx = invstd * w * (dy - mean(dy) - xhat * mean(dy * xhat))``.
    Only ``x`` is kept for the backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + _EPS_BN)
        shape = (1, -1, 1, 1)
        y = (x - mean.view(shape)) * (invstd * w).view(shape) \
            + b.view(shape)
        ctx.save_for_backward(x, w, mean, invstd)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        db = dy.sum((0, 2, 3))
        dw = (dy * xhat).sum((0, 2, 3))
        n = x.numel() // x.shape[1]
        dx = (invstd * w).view(shape) * (
            dy - (db / n).view(shape) - xhat * (dw / n).view(shape))
        return dx, dw, db


class _Net:
    """The backbone over a parameter dict (torchvision names under
    ``backbone.``); ``train`` uses batch statistics and collects the
    running-statistic updates in ``self.stats``."""

    def __init__(self, params: dict, depths, precision: str, train: bool):
        self.p, self.depths = params, depths
        self.prec, self.train = precision, train
        self.stats: dict = {}

    def conv(self, x, name, stride=1, padding=0):
        return conv2d(x, self.p[name + ".weight"], self.prec, stride, padding)

    def bn(self, x, name):
        if not self.train:
            return _bn_eval(x, self.p, name)
        y, mean, var = _BatchNormTrain.apply(x, self.p[name + ".weight"],
                                             self.p[name + ".bias"])
        self.stats[name] = (mean.detach(), var.detach())
        return y

    def block(self, x, name, stride, project):
        y = F.relu(self.bn(self.conv(x, name + ".conv1"), name + ".bn1"))
        y = F.relu(self.bn(self.conv(y, name + ".conv2", stride, 1),
                           name + ".bn2"))
        y = self.bn(self.conv(y, name + ".conv3"), name + ".bn3")
        if project:
            x = self.bn(self.conv(x, name + ".downsample.0", stride),
                        name + ".downsample.1")
        return F.relu(y + x)

    def __call__(self, x):
        """NCHW normalized images -> the layer4 map, NCHW."""
        y = F.relu(self.bn(self.conv(x, "backbone.conv1", 2, 3),
                           "backbone.bn1"))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                y = self.block(y, f"backbone.layer{s + 1}.{b}",
                               2 if s > 0 and b == 0 else 1, b == 0)
        return y


def _gem_whiten(fmap, p, gem_p: float, precision: str):
    pooled = torch.clamp(fmap, min=1e-6).pow(gem_p).mean((2, 3)) \
        .pow(1.0 / gem_p)
    return linear(pooled, p["whiten.weight"], p["whiten.bias"], precision)


def _l2(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _normalize(imgs_u8: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=imgs_u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=imgs_u8.device)
    return (imgs_u8.to(torch.float32) / 255.0 - m) / s


@torch.no_grad()
def descriptors(images, params: dict, cfg: dict, scales, mean, std,
                device, precision: str = "fp32") -> np.ndarray:
    """``[N, D]`` multi-scale descriptors of raw uint8 ``[h, w, 3]``
    images, each at its own size (images of one size share a batch)."""
    net = _Net(params, cfg["depths"], precision, train=False)
    out = np.zeros((len(images), cfg["outputdim"]), np.float32)
    by_size: dict = {}
    for i, img in enumerate(images):
        by_size.setdefault(img.shape[:2], []).append(i)
    with scope(precision):
        for (H, W), idx in by_size.items():
            for a in range(0, len(idx), 8):
                part = idx[a:a + 8]
                x = _normalize(torch.as_tensor(np.stack([images[i]
                                                         for i in part]),
                                               device=device), mean, std)
                acc, kept = 0, 0
                for s in scales:
                    h, w = int(math.floor(H * s)), int(math.floor(W * s))
                    if h < _MIN_SIDE or w < _MIN_SIDE:
                        continue
                    xs = x if (h, w) == (H, W) else triangle_resize(
                        x, h, w, precision)
                    fmap = net(xs.permute(0, 3, 1, 2).contiguous())
                    acc = acc + _l2(_gem_whiten(fmap, params, cfg["gem_p"],
                                                precision))
                    kept += 1
                out[part] = _l2(acc / kept).cpu().numpy()
    return out


def _arcface_loss(feats, cls_w, labels, s: float, m: float, precision):
    cos = matmul(_l2(feats), _l2(cls_w).t(), precision)
    theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-6, 1.0 - 1e-6))
    one_hot = F.one_hot(labels, cls_w.shape[0]).bool()
    sel = one_hot & ~(theta > math.pi - m)
    logits = torch.cos(torch.where(sel, theta + m, theta)) * s
    logz = torch.logsumexp(logits, dim=-1)
    return (logz - logits.gather(1, labels[:, None])[:, 0]).mean()


def train_steps(params: dict, batches, cfg: dict, opt: dict, mean, std,
                precision: str = "fp32", rows: int | None = None) -> dict:
    """Run ``len(batches)`` training steps from ``params`` (a dict of fp32
    tensors, updated in place) over ``(uint8 [B, H, W, 3], labels [B])``
    batches; ``rows`` keeps only the first rows of each batch (a planted
    fault).  Returns each step's loss, the first step's gradient per leaf
    as the optimizer takes it (after clipping), and the parameters and
    running statistics after the last step."""
    names = [k for k, v in params.items() if v.is_floating_point()
             and not k.endswith(("running_mean", "running_var"))]
    leaves = {k: params[k].detach().clone().requires_grad_(True)
              for k in names}
    bufs = {k: v.detach().clone() for k, v in params.items()
            if k.endswith(("running_mean", "running_var"))}
    momentum = {}
    losses, first_grads = [], None
    with scope(precision):
        for step, (imgs, labels) in enumerate(batches):
            if rows is not None:
                imgs, labels = imgs[:rows], labels[:rows]
            net = _Net({**bufs, **leaves}, cfg["depths"], precision,
                       train=True)
            x = _normalize(imgs, mean, std).permute(0, 3, 1, 2) \
                .contiguous(memory_format=torch.channels_last)
            fmap = net(x)
            feats = _gem_whiten(fmap, leaves, cfg["gem_p"], precision)
            loss = _arcface_loss(feats, leaves["classifier_w"],
                                 labels.long(), cfg["arcface_s"],
                                 cfg["arcface_m"], precision)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
                clip = opt["clip"]
                grads = [torch.where(norm < clip, g, g / norm * clip)
                         for g in grads]
                if first_grads is None:
                    first_grads = {k: g.clone() for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    p = leaves[k]
                    d = g + opt["weight_decay"] * p if p.dim() > 1 else g
                    buf = momentum.get(k)
                    buf = d.clone() if buf is None else \
                        buf.mul_(opt["momentum"]).add_(d)
                    momentum[k] = buf
                    p.sub_(opt["lr"] * (d + opt["momentum"] * buf))
                for name, (bm, bv) in net.stats.items():
                    for leaf, v in (("running_mean", bm), ("running_var", bv)):
                        r = bufs[f"{name}.{leaf}"]
                        r.mul_(0.9).add_(0.1 * v)
            del net, fmap, feats, loss, grads
    final = {k: v.detach() for k, v in leaves.items()}
    final.update(bufs)
    return {"losses": losses, "first_grads": first_grads, "final": final}
