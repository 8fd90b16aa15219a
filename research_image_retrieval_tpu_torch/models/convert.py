"""Weight bridge into the port's models.

* ``from_jax_variables``: flax ``{"params", "batch_stats"}`` of the JAX
  ``ResNet`` or ``GeMModel`` (as numpy arrays) -> the port's state dict.
  The inverse of the JAX ``convert_torch_resnet``: conv kernels HWIO ->
  OIHW, BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
  running_var``, the Dense ``whiten.kernel [C, D]`` -> Linear
  ``weight [D, C]``, and block names ``layer{i}_{j}`` -> ``layer{i}.{j}``.
* ``load_torchvision_resnet``: a torchvision-layout ResNet state dict
  (optionally under a ``backbone.`` prefix) -> the port's ``ResNet``
  state dict; the names already agree.
* ``seeded_init``: fills every parameter and buffer of a module from one
  seeded ``torch.Generator``, at scales that keep a deep ResNet's
  activations finite and O(1), for runs that need random but
  reproducible weights.
* ``training_init``: the JAX models' initializers, for training from
  scratch: the same laws, drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

__all__ = ["from_jax_variables", "load_torchvision_resnet", "seeded_init",
           "training_init"]

# std of a unit normal truncated to [-2, 2], by which flax's
# ``lecun_normal`` (a truncated normal) divides its scale
_TRUNC_STD = 0.87962566103423978


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _resnet_from_flax(params: dict, stats: dict, prefix: str) -> dict:
    sd = {}

    def conv(dst: str, p: dict):
        sd[f"{prefix}{dst}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                                      (3, 2, 0, 1)))

    def bn(dst: str, p: dict, s: dict):
        sd[f"{prefix}{dst}.weight"] = _t(p["scale"])
        sd[f"{prefix}{dst}.bias"] = _t(p["bias"])
        sd[f"{prefix}{dst}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}{dst}.running_var"] = _t(s["var"])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for key in params:
        if not key.startswith("layer"):
            continue
        stage, j = key[len("layer"):].split("_")
        dst = f"layer{stage}.{j}"
        bp, bs = params[key], stats[key]
        for k in (1, 2, 3) if "conv3" in bp else (1, 2):  # bottleneck, basic
            conv(f"{dst}.conv{k}", bp[f"conv{k}"])
            bn(f"{dst}.bn{k}", bp[f"bn{k}"], bs[f"bn{k}"])
        if "downsample_conv" in bp:
            conv(f"{dst}.downsample.0", bp["downsample_conv"])
            bn(f"{dst}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
    return sd


def from_jax_variables(variables: dict) -> dict:
    """Port state dict from flax variables of ``ResNet`` or ``GeMModel``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "backbone" not in params:  # a bare ResNet
        return _resnet_from_flax(params, stats, "")
    sd = _resnet_from_flax(params["backbone"], stats["backbone"], "backbone.")
    sd["whiten.weight"] = _t(np.asarray(params["whiten"]["kernel"]).T)
    sd["whiten.bias"] = _t(params["whiten"]["bias"])
    if "classifier_w" in params:
        sd["classifier_w"] = _t(params["classifier_w"])
    if "gem_p" in params:
        sd["gem_p"] = _t(params["gem_p"])
    return sd


def load_torchvision_resnet(state_dict: dict) -> dict:
    """torchvision ResNet keys (bare or under ``backbone.``) -> the port's
    ``ResNet`` state dict (fp32 tensors; ``fc.*`` and
    ``num_batches_tracked`` dropped)."""
    prefixed = any(k.startswith("backbone.") for k in state_dict)
    out = {}
    for k, v in state_dict.items():
        if prefixed:
            if not k.startswith("backbone."):
                continue  # a whole model: keep only its backbone
            k = k[len("backbone."):]
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.as_tensor(v).detach().to("cpu", torch.float32).clone()
    return out


def seeded_init(module: nn.Module, seed: int) -> None:
    """Fill every parameter and buffer from ``torch.Generator(seed)`` in
    sorted state-dict order: conv/linear weights N(0, 1/fan_in), BN
    weight 1 + 0.1 N, BN bias and running mean 0.1 N, running var
    |N| + 0.5, other vectors 0.1 N.  A learnable GeM ``gem_p`` keeps its
    value."""
    gen = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    with torch.no_grad():
        for k in sorted(sd):
            t = sd[k]
            if k.endswith("num_batches_tracked") or k == "gem_p":
                continue
            v = torch.randn(tuple(t.shape), generator=gen, dtype=torch.float32)
            if k.endswith("running_var"):
                v = v.abs() + 0.5
            elif t.dim() > 1:
                v = v / math.sqrt(max(int(np.prod(t.shape[1:])), 1))
            elif k.endswith("weight"):
                v = 1.0 + 0.1 * v
            else:
                v = 0.1 * v
            t.copy_(v)


def training_init(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize as the JAX models do, drawing from ``generator`` in
    module order: every conv and linear weight ``lecun_normal`` (flax's:
    normal with std ``sqrt(1 / fan_in) / 0.8796``, truncated at two std),
    biases 0; BN scale 1, bias 0, running mean 0, running variance 1; a
    ``classifier_w`` xavier-uniform.  A learnable GeM ``gem_p`` keeps its
    value.  torch's default conv init (kaiming-uniform, a = sqrt(5)) has a
    third of this variance and is not used.
    """
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        cls_w = getattr(module, "classifier_w", None)
        if cls_w is not None:
            nn.init.xavier_uniform_(cls_w, generator=generator)
