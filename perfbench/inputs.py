"""Inputs made from a run's seed: sub-seeds, images, weights, galleries.

Every input is made by the benchmark and handed to the program and to
the reference alike.  Sizes come from the traffic mix and are the same
for every seed; the seed changes only content and order, so two seeds
ask for the same work.  Large things are made on the run's device with
a seeded ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "encode_jpeg", "gallery_blocks",
           "render_batch", "renders", "resnet_gem_shapes", "resnet_gem_weights",
           "sub_seed", "train_batches"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def render_batch(n: int, h: int, w: int, gen: torch.Generator, device,
                 noise: float = 0.25) -> torch.Tensor:
    """``[n, h, w, 3]`` uint8 renders on ``device``: smooth
    multi-frequency fields plus noise (the serving fixture's renders),
    each stretched to 0-255."""
    f = 2 + 7 * torch.rand((n, 4, 3), generator=gen, device=device)
    yy = torch.linspace(0, 1, h, device=device)[None, :, None, None]
    xx = torch.linspace(0, 1, w, device=device)[None, None, :, None]
    img = (torch.sin(2 * math.pi * (f[:, None, None, 0] * xx
                                    + f[:, None, None, 2]))
           + torch.cos(2 * math.pi * (f[:, None, None, 1] * yy
                                      + f[:, None, None, 3])))
    img = img + noise * torch.randn((n, h, w, 3), generator=gen,
                                    device=device)
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return torch.round((img - lo) / (hi - lo) * 255).to(torch.uint8)


def renders(sizes, seed: int, device, noise: float = 0.25,
            group: int = 16) -> list[np.ndarray]:
    """``render_batch`` images of the given (h, w), made on ``device`` in
    groups of equal size and returned on the host in the order of
    ``sizes``."""
    gen = _generator(seed, device)
    out: list = [None] * len(sizes)
    by_size: dict = {}
    for i, hw in enumerate(sizes):
        by_size.setdefault(tuple(hw), []).append(i)
    for (h, w), idx in sorted(by_size.items()):
        for a in range(0, len(idx), group):
            part = idx[a:a + group]
            host = render_batch(len(part), h, w, gen, device,
                                noise).cpu().numpy()
            for j, i in enumerate(part):
                out[i] = host[j]
    return out


def encode_jpeg(img: np.ndarray, quality: int) -> bytes:
    """RGB uint8 -> baseline JPEG bytes, 4:2:0, through OpenCV."""
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, int(quality)]
    if hasattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR"):
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                           params)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def resnet_gem_shapes(cfg: dict) -> dict:
    """``{name: shape}`` of a ResNet-GeM's state in torchvision's naming
    under ``backbone.``, then ``whiten`` and the ArcFace ``classifier_w``,
    from the configuration's published sizes."""
    shapes = {}

    def conv(name, cout, cin, k):
        shapes[name + ".weight"] = (cout, cin, k, k)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = (c,)
        shapes[f"{name}.num_batches_tracked"] = ()

    conv("backbone.conv1", cfg["stem_width"], 3, 7)
    bn("backbone.bn1", cfg["stem_width"])
    cin = cfg["stem_width"]
    for s, (depth, width) in enumerate(zip(cfg["depths"], cfg["widths"])):
        cout = cfg["expansion"] * width
        for b in range(depth):
            p = f"backbone.layer{s + 1}.{b}"
            conv(p + ".conv1", width, cin, 1)
            bn(p + ".bn1", width)
            conv(p + ".conv2", width, width, 3)
            bn(p + ".bn2", width)
            conv(p + ".conv3", cout, width, 1)
            bn(p + ".bn3", cout)
            if b == 0:
                conv(p + ".downsample.0", cout, cin, 1)
                bn(p + ".downsample.1", cout)
            cin = cout
    shapes["whiten.weight"] = (cfg["outputdim"], cin)
    shapes["whiten.bias"] = (cfg["outputdim"],)
    shapes["classifier_w"] = (cfg["num_classes"], cfg["outputdim"])
    return shapes


def resnet_gem_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded weights of a ResNet-GeM, made on ``device`` from one normal
    draw: convolution and linear weights ``N(0, 1/fan_in)``, BN scales
    ``1 + 0.1 N``, biases and running means ``0.1 N``, running variances
    ``|N| + 0.5`` (the port's ``seeded_init`` distributions, which keep a
    deep network's activations in range with eval-mode BN)."""
    shapes = resnet_gem_shapes(cfg)
    sizes = {k: math.prod(s) for k, s in shapes.items()
             if not k.endswith("num_batches_tracked")}
    flat = torch.randn((sum(sizes.values()),), generator=_generator(seed,
                       device), device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        v = flat[at:at + sizes[k]].view(shape)
        at += sizes[k]
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v = v.abs() + 0.5
        elif len(shape) > 1:
            v = v / math.sqrt(math.prod(shape[1:]))
        elif leaf == "weight":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[k] = v.contiguous()
    return out


def gallery_blocks(n: int, dim: int, seed: int, device, block: int = 65536):
    """Unit rows of an ``n`` x ``dim`` gallery, ``(start, [rows, dim]
    fp32)`` block by block, from one seeded generator: the same seed
    gives the same rows, so the reference can make them again."""
    gen = _generator(seed, device)
    for b in range(0, n, block):
        e = min(b + block, n)
        blk = torch.randn((e - b, dim), generator=gen, device=device)
        yield b, blk / torch.linalg.vector_norm(blk, dim=1, keepdim=True)


def train_batches(n: int, batch: int, size: int, classes: int, seed: int,
                  device, noise: float = 0.25) -> list:
    """``n`` training batches ``(uint8 [batch, size, size, 3], int64
    labels [batch])`` on ``device``, every row its own render and labels
    drawn uniformly over ``classes``."""
    gen = _generator(seed, device)
    out = []
    for _ in range(n):
        imgs = render_batch(batch, size, size, gen, device, noise)
        labels = torch.randint(0, classes, (batch,), generator=gen,
                               device=device)
        out.append((imgs, labels))
    return out
