"""OpenAI-layout CLIP state dict -> the port's CLIP modules
(port of ``research_image_retrieval_tpu/models/clip_convert.py``).

The architecture is read off the state dict's keys, as the reference's
``build_model`` does: a ViT tower when ``visual.proj`` exists (width,
patch, grid and depth from the shapes; the head count from the
``VIT_CONFIGS`` entry they match), the ModifiedResNet otherwise (stage
depths and width; ``heads = 32 * width // 64``).  The ResNet tower's
names are OpenAI's, so its keys load as they are; the ViT and text
towers' packed ``in_proj_weight`` splits into the ``query`` / ``key`` /
``value`` projections, ``ln_1`` / ``c_fc`` become ``ln1`` / ``mlp_fc1``,
and the ``x @ proj`` matrices (``visual.proj``, ``text_projection``)
become Linear weights.  Nothing is downloaded: callers pass the state
dict.
"""

from __future__ import annotations

import math

import torch

__all__ = ["build_clip_from_torch", "convert_clip_visual_vit",
           "convert_torch_clip", "load_clip_visual_into"]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).clone()


def _blocks(sd: dict, src: str, dst: str, depth: int, heads: int) -> dict:
    """OpenAI residual attention blocks ``{src}.{i}`` -> ``{dst}block{i}``
    (the q / k / v biases ``[heads, head_dim]``)."""
    out = {}
    for i in range(depth):
        p, q = f"{src}.{i}", f"{dst}block{i}"
        w = _t(sd[f"{p}.attn.in_proj_weight"])
        b = _t(sd[f"{p}.attn.in_proj_bias"])
        d = w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            out[f"{q}.attn.{name}.weight"] = w[j * d:(j + 1) * d]
            out[f"{q}.attn.{name}.bias"] = b[j * d:(j + 1) * d].reshape(
                heads, -1)
        out[f"{q}.attn.out.weight"] = _t(sd[f"{p}.attn.out_proj.weight"])
        out[f"{q}.attn.out.bias"] = _t(sd[f"{p}.attn.out_proj.bias"])
        for a, c in (("ln_1", "ln1"), ("ln_2", "ln2"), ("mlp.c_fc", "mlp_fc1"),
                     ("mlp.c_proj", "mlp_fc2")):
            out[f"{q}.{c}.weight"] = _t(sd[f"{p}.{a}.weight"])
            out[f"{q}.{c}.bias"] = _t(sd[f"{p}.{a}.bias"])
    return out


def _depth(sd: dict, prefix: str, part: int) -> int:
    return len({k.split(".")[part] for k in sd if k.startswith(prefix)})


def _match_vit_variant(cfg: dict) -> str:
    from research_image_retrieval_tpu_torch.models.vit import VIT_CONFIGS

    for name, c in VIT_CONFIGS.items():
        if all(cfg[k] == c[k] for k in ("dim", "depth", "patch")):
            return name
    raise ValueError(f"no VIT_CONFIGS entry matches checkpoint config {cfg}")


def _match_resnet_variant(cfg: dict) -> str:
    from research_image_retrieval_tpu_torch.models.clip_resnet import (
        CLIP_RESNET_CONFIGS,
    )

    for name, c in CLIP_RESNET_CONFIGS.items():
        if tuple(cfg["layers"]) == tuple(c["layers"]) \
                and cfg["width"] == c["width"]:
            return name
    raise ValueError(
        f"no CLIP_RESNET_CONFIGS entry matches checkpoint config {cfg}")


def _visual_vit(sd: dict):
    """``visual.*`` ViT keys -> (``VisionTransformer`` state dict, cfg)."""
    from research_image_retrieval_tpu_torch.models.vit import VIT_CONFIGS

    width, _, _, patch = sd["visual.conv1.weight"].shape
    grid = round(math.sqrt(sd["visual.positional_embedding"].shape[0] - 1))
    depth = _depth(sd, "visual.transformer.resblocks", 3)
    cfg = dict(dim=int(width), depth=int(depth), patch=int(patch))
    variant = _match_vit_variant(cfg)
    cfg.update(heads=VIT_CONFIGS[variant]["heads"], img_size=int(patch * grid),
               variant=variant)
    out = {"patch_embed.weight": _t(sd["visual.conv1.weight"]),
           "cls_token": _t(sd["visual.class_embedding"]).reshape(1, 1, -1),
           "pos_embed": _t(sd["visual.positional_embedding"])[None]}
    for ln in ("ln_pre", "ln_post"):
        out[f"{ln}.weight"] = _t(sd[f"visual.{ln}.weight"])
        out[f"{ln}.bias"] = _t(sd[f"visual.{ln}.bias"])
    out.update(_blocks(sd, "visual.transformer.resblocks", "", depth,
                       cfg["heads"]))
    return out, cfg


def convert_clip_visual_vit(sd: dict):
    """The ViT visual tower alone: ``(VisionTransformer state dict, proj
    [width, embed] as used in x @ proj, cfg)``."""
    out, cfg = _visual_vit(sd)
    return out, _t(sd["visual.proj"]), cfg


def _visual_resnet(sd: dict):
    """``visual.*`` ModifiedResNet keys -> (``ModifiedResNet`` state
    dict, cfg).  A checkpoint without BN ``num_batches_tracked`` gets
    zeros there."""
    out = {k[len("visual."):]: _t(v) for k, v in sd.items()
           if k.startswith("visual.")}
    for k in [k for k in out if k.endswith("running_var")]:
        out.setdefault(k.replace("running_var", "num_batches_tracked"),
                       torch.zeros((), dtype=torch.int64))
    layers = tuple(_depth(sd, f"visual.layer{i}.", 2) for i in range(1, 5))
    width = sd["visual.layer1.0.conv1.weight"].shape[0]
    spacial = round(math.sqrt(
        sd["visual.attnpool.positional_embedding"].shape[0] - 1))
    cfg = dict(layers=layers, width=int(width), heads=int(width * 32 // 64),
               img_size=int(spacial * 32))
    return out, cfg


def convert_torch_clip(state_dict: dict):
    """Both towers: ``(state dict of the port's CLIP, config)``, the
    config being ``CLIP``'s keyword arguments."""
    sd = {k: v for k, v in state_dict.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    embed_dim = sd["text_projection"].shape[1]
    context_length = sd["positional_embedding"].shape[0]
    vocab_size = sd["token_embedding.weight"].shape[0]
    text_width = sd["ln_final.weight"].shape[0]
    text_heads = max(1, text_width // 64)  # OpenAI's convention
    text_depth = _depth(sd, "transformer.resblocks", 2)
    out = {f"text.{k}": v for k, v in _blocks(
        sd, "transformer.resblocks", "", text_depth, text_heads).items()}
    out.update({
        "text.token_embedding.weight": _t(sd["token_embedding.weight"]),
        "text.positional_embedding": _t(sd["positional_embedding"]),
        "text.ln_final.weight": _t(sd["ln_final.weight"]),
        "text.ln_final.bias": _t(sd["ln_final.bias"]),
        "text.text_projection.weight": _t(sd["text_projection"]).t()
                                       .contiguous(),
        "logit_scale": _t(sd["logit_scale"]).reshape(()),
    })
    if "visual.proj" in sd:
        vis, vcfg = _visual_vit(sd)
        variant = vcfg["variant"]
        out["visual_projection.weight"] = _t(sd["visual.proj"]).t() \
            .contiguous()
    else:
        vis, vcfg = _visual_resnet(sd)
        variant = _match_resnet_variant(vcfg)
    out.update({f"visual.{k}": v for k, v in vis.items()})
    config = dict(visual_variant=variant, embed_dim=int(embed_dim),
                  vocab_size=int(vocab_size),
                  context_length=int(context_length),
                  text_dim=int(text_width), text_depth=int(text_depth),
                  text_heads=int(text_heads), img_size=int(vcfg["img_size"]))
    return out, config


def load_clip_visual_into(model, state_dict: dict):
    """Load an OpenAI-layout checkpoint's VISUAL tower (and a ViT's
    projection) into a ``CLIPGlobalModel`` or ``CLIP`` in place; the
    classifier and any text tower keep their values.  Returns
    ``model``."""
    sd = dict(state_dict)
    if "visual.proj" in sd:
        vis, _ = _visual_vit(sd)
        model.visual.load_state_dict(vis, strict=True)
        if hasattr(model, "visual_projection"):
            with torch.no_grad():
                model.visual_projection.weight.copy_(
                    _t(sd["visual.proj"]).t())
        return model
    vis, _ = _visual_resnet(sd)
    model.visual.load_state_dict(vis, strict=True)
    return model


def build_clip_from_torch(state_dict: dict):
    """State dict -> ``(CLIP module with its weights, its state dict)``:
    the reference's ``build_model``."""
    from research_image_retrieval_tpu_torch.models.clip import CLIP

    sd, config = convert_torch_clip(state_dict)
    model = CLIP(**config)
    model.load_state_dict(sd, strict=True)
    return model.eval(), sd
