"""Seeded weights of a ViT global descriptor, made on the run's device.

The names and shapes are the port's state dict for ``ViTGlobalModel``
(``backbone.`` then ``whiten`` and the ArcFace ``classifier_w``), worked
out here from the configuration's published sizes; the harness loads
them strictly, so a name or shape the port does not have fails the run.
"""

from __future__ import annotations

import math

import torch

from perfbench.inputs import _generator

__all__ = ["vit_shapes", "vit_weights"]


def vit_shapes(cfg: dict) -> dict:
    """``{name: shape}`` of a ViT global descriptor's state."""
    d, P, mlp = cfg["dim"], cfg["patch"], cfg["mlp"]
    hd = d // cfg["heads"]
    native = cfg["img_size"] // P
    shapes = {"backbone.patch_embed.weight": (d, 3, P, P),
              "backbone.cls_token": (1, 1, d),
              "backbone.pos_embed": (1, native * native + 1, d)}

    def ln(name):
        shapes[name + ".weight"] = (d,)
        shapes[name + ".bias"] = (d,)

    for i in range(cfg["depth"]):
        b = f"backbone.block{i}"
        ln(b + ".ln1")
        for proj in ("query", "key", "value"):
            shapes[f"{b}.attn.{proj}.weight"] = (d, d)
            shapes[f"{b}.attn.{proj}.bias"] = (cfg["heads"], hd)
        shapes[b + ".attn.out.weight"] = (d, d)
        shapes[b + ".attn.out.bias"] = (d,)
        ln(b + ".ln2")
        shapes[b + ".mlp_fc1.weight"] = (mlp, d)
        shapes[b + ".mlp_fc1.bias"] = (mlp,)
        shapes[b + ".mlp_fc2.weight"] = (d, mlp)
        shapes[b + ".mlp_fc2.bias"] = (d,)
    ln("backbone.ln_post")
    shapes["whiten.weight"] = (cfg["outputdim"], 2 * d)
    shapes["whiten.bias"] = (cfg["outputdim"],)
    shapes["classifier_w"] = (cfg["num_classes"], cfg["outputdim"])
    return shapes


def vit_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded weights from one normal draw on ``device``: matrices and
    the patch kernel ``N(0, 1/fan_in)``, LayerNorm scales ``1 + 0.1 N``,
    biases (the attention's ``[heads, head_dim]`` ones too) and LayerNorm
    shifts ``0.1 N`` (the port's ``seeded_init`` laws); the CLS token and
    the position embedding ``0.02 N`` (the port's ``reset_flax``)."""
    shapes = vit_shapes(cfg)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.randn((sum(sizes.values()),), generator=_generator(seed,
                       device), device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, shape in shapes.items():
        v = flat[at:at + sizes[k]].view(shape)
        at += sizes[k]
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "pos_embed"):
            v = 0.02 * v
        elif leaf == "bias":
            v = 0.1 * v
        elif len(shape) > 1:
            v = v / math.sqrt(math.prod(shape[1:]))
        else:
            v = 1.0 + 0.1 * v
        out[k] = v.contiguous()
    return out
