"""Weight bridge into the port's models.

* ``from_jax_variables``: flax ``{"params", "batch_stats"}`` of the JAX
  ``ResNet``, of a model over one (``params["backbone"]``: the GeM,
  DOLG, SOLAR, DELG, SpCa, SoSNet, SpoC, AdaptiveHybrid, Token and HOW
  models; ``params["encoder"]``: ``CVNetRerank``; ``params["visual"]``:
  CLIP's ModifiedResNet, with its three stem convolutions and its
  ``attnpool``), of ``SENetG2Model`` (no backbone subtree; its own
  ``conv1``, ``bn1`` and ``layer{i}_{j}`` at the top level) or of a
  transformer model (ViT, CLIP's ViT and text towers, ULTRON: their
  flax names throughout); numpy arrays -> the port's state dict.  The inverse of the JAX ``convert_torch_resnet`` for the
  backbone (conv kernels HWIO -> OIHW, BN ``scale/bias/mean/var`` ->
  ``weight/bias/running_mean/running_var``, ``layer{i}_{j}`` ->
  ``layer{i}.{j}``); the rest keeps its flax names, recursively: Dense
  kernels ``[C, D]`` -> Linear ``weight [D, C]`` (attention's
  ``DenseGeneral`` kernels ``[D, h, hd]`` and ``out`` ``[h, hd, D]``
  flattened to the same, their ``[h, hd]`` biases kept), convolutions as above, LayerNorm ``scale`` ->
  ``weight``, ``Embed`` ``embedding`` -> ``weight``, bare parameters
  (``classifier_w``, ``gem_p``, ``clusters``, ``pos_embed``, ...) as
  they are.  The
  scopes that flax gives modules made inside ``nn.compact_name_scope``
  methods (SpoC's ``_context`` / ``_features``, AdaptiveHybrid's
  ``descriptors``) are flattened into the model, where the port keeps
  those modules.  The four research prototypes (SPECTRUM, IRIS, SPARSE, HAMLET) map
  by the same rules: attention's ``MultiHeadDotProductAttention`` and
  ``layers.Attention`` projections, the ``_ProjMLP`` LayerNorms,
  ``ContextEnhancedConv``'s BN statistics, and SPARSE's bare ``scale``
  and ``zero_point`` (a dict is a norm only when it holds nothing but
  ``scale`` and ``bias``).  ``qaff_from_flax``: the same for a ``QAFF``.
* ``load_torchvision_resnet``: a torchvision-layout ResNet state dict
  (optionally under a ``backbone.`` prefix) -> the port's ``ResNet``
  state dict; the names already agree.  ``load_pycls_resnet`` (the
  reference's scratch DOLG backbone, for ``stride_on_conv1``) and
  ``load_features_resnet`` (a Caffe ``nn.Sequential`` ResNet) rename
  their layouts' keys to torchvision's first.
* ``seeded_init``: fills every parameter and buffer of a module from one
  seeded ``torch.Generator``, at scales that keep a deep ResNet's
  activations finite and O(1), for runs that need random but
  reproducible weights.
* ``training_init``: the JAX models' initializers, for training from
  scratch: the same laws, drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.layers import LayerNorm

__all__ = ["from_jax_variables", "load_features_resnet", "load_pycls_resnet",
           "load_torchvision_resnet", "qaff_from_flax", "seeded_init",
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

    for k in (1, 2, 3):  # CLIP's ModifiedResNet has a three-conv stem
        if f"conv{k}" in params:
            conv(f"conv{k}", params[f"conv{k}"])
            bn(f"bn{k}", params[f"bn{k}"], stats[f"bn{k}"])
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


def _heads_from_flax(params: dict, stats: dict, prefix: str, sd: dict):
    """A model's non-backbone flax modules under their flax names: Dense
    and Conv (``kernel`` [+ ``bias``]; attention's ``DenseGeneral``
    kernels flattened over their head axes), BatchNorm (``scale``/``bias``
    + the stats), LayerNorm (``scale``/``bias``, no stats) and Embed
    (``embedding``), submodules recursively, and bare arrays
    (``classifier_w``, ``gem_p``) as they are."""
    for name, p in params.items():
        key = prefix + name
        if not isinstance(p, dict):
            sd[key] = _t(p)
        elif "kernel" in p:
            k = np.asarray(p["kernel"])
            if k.ndim == 4:
                w = np.transpose(k, (3, 2, 0, 1))
            elif k.ndim == 3:  # DenseGeneral: [D, h, hd] or out [h, hd, D]
                w = (k.reshape(-1, k.shape[-1]) if name == "out"
                     else k.reshape(k.shape[0], -1)).T
            else:
                w = k.T
            sd[f"{key}.weight"] = _t(w)
            if "bias" in p:
                sd[f"{key}.bias"] = _t(p["bias"])
        elif "embedding" in p:
            sd[f"{key}.weight"] = _t(p["embedding"])
        elif set(p) <= {"scale", "bias"}:  # a norm (SPARSE's quantizer
            sd[f"{key}.weight"] = _t(p["scale"])  # has a bare ``scale``)
            sd[f"{key}.bias"] = _t(p["bias"])
            if name in stats:  # BatchNorm; a LayerNorm has none
                sd[f"{key}.running_mean"] = _t(stats[name]["mean"])
                sd[f"{key}.running_var"] = _t(stats[name]["var"])
        else:
            _heads_from_flax(p, stats.get(name, {}), f"{key}.", sd)


# flax scopes of modules made inside ``nn.compact_name_scope`` methods
_NAME_SCOPES = ("_context", "_features", "descriptors")


def _flatten_name_scopes(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(v if k in _NAME_SCOPES else {k: v})
    return out


def _is_resnet(tree) -> bool:
    """Whether a flax subtree is a ResNet trunk (CLIP's with its
    ``attnpool``)."""
    return isinstance(tree, dict) and "layer1_0" in tree and all(
        re.fullmatch(r"conv\d|bn\d|layer\d+_\d+|attnpool", k) for k in tree)


def from_jax_variables(variables: dict) -> dict:
    """Port state dict from flax variables of ``ResNet``, of a model
    whose backbone is one (``params["backbone"]``, CVNet's
    ``params["encoder"]`` or CLIP's ModifiedResNet ``params["visual"]``),
    of a model with its own layers at the top level (``SENetG2Model``)
    or of a transformer model (every name its flax name).  The
    ``model_state`` collection (RetrievalNet's ``arcface_t``) becomes
    buffers of the same names."""
    params = _flatten_name_scopes(variables["params"])
    stats = _flatten_name_scopes(variables.get("batch_stats", {}))
    sd = {k: _t(v) for k, v in variables.get("model_state", {}).items()}
    trunk = next((k for k in ("backbone", "encoder", "visual")
                  if _is_resnet(params.get(k))), None)
    if trunk is None:
        if _is_resnet(params):  # a bare ResNet or ModifiedResNet
            return _trunk_from_flax(params, stats, "")
        _heads_from_flax(params, stats, "", sd)
        return sd
    sd.update(_trunk_from_flax(params[trunk], stats[trunk], f"{trunk}."))
    _heads_from_flax({k: v for k, v in params.items() if k != trunk},
                     stats, "", sd)
    return sd


def _trunk_from_flax(params: dict, stats: dict, prefix: str) -> dict:
    """A ResNet trunk, and the ``attnpool`` of CLIP's ModifiedResNet."""
    sd = _resnet_from_flax(params, stats, prefix)
    if "attnpool" in params:
        _heads_from_flax({"attnpool": params["attnpool"]}, {}, prefix, sd)
    return sd


def qaff_from_flax(params: dict) -> dict:
    """State dict of ``QAFF`` from the JAX module's flax params (numpy
    arrays; ``{"params": ...}`` or the params tree itself)."""
    sd = {}
    _heads_from_flax(params.get("params", params), {}, "", sd)
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


_PYCLS = {"a": "conv1", "a_bn": "bn1", "b": "conv2", "b_bn": "bn2",
          "c": "conv3", "c_bn": "bn3"}


def load_pycls_resnet(state_dict: dict) -> dict:
    """A pycls-layout ResNet (``stem.{conv,bn}``, ``s{i}.b{j}.f.{a,a_bn,
    b,b_bn,c,c_bn}``, ``s{i}.b{j}.{proj,bn}`` on shape-changing blocks;
    the reference's scratch DOLG backbone) -> the port's ``ResNet`` state
    dict.  pycls strides the first 1x1: load it into a model built with
    ``stride_on_conv1=True`` (``dolg_r101_scratch``).  Other keys are
    dropped."""
    out = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] == "stem" and parts[1] in ("conv", "bn"):
            dst = {"conv": "conv1", "bn": "bn1"}[parts[1]]
            out[".".join([dst, *parts[2:]])] = v
        elif re.fullmatch(r"s\d+", parts[0]) and parts[1].startswith("b"):
            block = f"layer{parts[0][1:]}.{int(parts[1][1:]) - 1}"
            if parts[2] == "f" and parts[3] in _PYCLS:
                out[".".join([block, _PYCLS[parts[3]], *parts[4:]])] = v
            elif parts[2] in ("proj", "bn"):
                sub = "0" if parts[2] == "proj" else "1"
                out[".".join([block, "downsample", sub, *parts[3:]])] = v
    return load_torchvision_resnet(out)


def load_features_resnet(state_dict: dict) -> dict:
    """A ResNet keyed by ``nn.Sequential`` indices over torchvision's
    children (the reference's Caffe-converted ``filip`` weights: ``0`` =
    conv1, ``1`` = bn1, ``4``-``7`` = layer1-4) -> the port's ``ResNet``
    state dict.  Pair it with the Caffe input convention (BGR, 0-255)."""
    out = {}
    for k, v in state_dict.items():
        head, _, rest = k.partition(".")
        if head == "0":
            out["conv1." + rest] = v
        elif head == "1":
            out["bn1." + rest] = v
        elif head in ("4", "5", "6", "7"):
            out[f"layer{int(head) - 3}." + rest] = v
    return load_torchvision_resnet(out)


def seeded_init(module: nn.Module, seed: int) -> None:
    """Fill every parameter and buffer from ``torch.Generator(seed)`` in
    sorted state-dict order: conv/linear weights N(0, 1/fan_in), BN
    weight 1 + 0.1 N, biases (attention's ``[heads, head_dim]`` too) and
    BN running mean 0.1 N, running var |N| + 0.5, other vectors 0.1 N.  Parameters a log or a square root
    reads (SpCa's ``pi`` and ``cov``) get |N| + 0.5, G2+'s ``g2_alpha``
    and ASMK's cluster ``weights`` 1 + 0.1 N; a learnable GeM ``gem_p``,
    ULTRON's pooling exponent ``gamma``, CLIP's ``logit_scale``,
    RetrievalNet's EMA state ``arcface_t`` and SPARSE's quantizer
    ``scale`` and ``zero_point`` keep their values (1 and 0 from the
    constructor: at ``|0.1 N| + 1e-6`` the scale would divide the
    features into saturation, every code at its ``2^bits - 1``)."""
    gen = torch.Generator().manual_seed(seed)
    sd = module.state_dict()
    with torch.no_grad():
        for k in sorted(sd):
            t = sd[k]
            if (k.endswith("num_batches_tracked")
                    or k in ("gem_p", "arcface_t")
                    or k.rsplit(".", 1)[-1] in ("gamma", "logit_scale",
                                                "scale", "zero_point")):
                continue
            v = torch.randn(tuple(t.shape), generator=gen, dtype=torch.float32)
            leaf = k.rsplit(".", 1)[-1]
            if leaf in ("running_var", "pi", "cov"):
                v = v.abs() + 0.5
            elif leaf in ("g2_alpha", "weights"):
                v = 1.0 + 0.1 * v
            elif t.dim() > 1 and leaf != "bias":
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
    biases 0 (flax's ``Dense`` / ``Conv`` defaults); a module marked
    ``zero_init`` (SOLAR's ``v``, ``Attention.proj``) all zeros; BN and
    LayerNorm scale 1, bias 0, BN running mean 0, running variance 1; a
    ``classifier_w`` xavier-uniform; a module's own parameters by its
    ``reset_flax(generator)`` (SpCa's codebook, G2+'s affine, Token's
    queries, HOW's centroids and ASMK weights, CVNet's GroupNorms, the
    transformers' position embeddings and tokens, ULTRON's channel
    attention weights and bias tables, CLIP's text embeddings).  A
    learnable GeM ``gem_p``, ULTRON's ``gamma`` (2.0) and CLIP's
    ``logit_scale`` keep their values.  torch's default conv init
    (kaiming-uniform, a = sqrt(5)) has a third of this variance and is
    not used.
    """
    with torch.no_grad():
        for mod in module.modules():
            if getattr(mod, "zero_init", False):  # SOLAR's v, Attention.proj
                mod.weight.zero_()
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, LayerNorm)):
                mod.reset_parameters()
            if hasattr(mod, "reset_flax"):
                mod.reset_flax(generator)
        cls_w = getattr(module, "classifier_w", None)
        if cls_w is not None:
            nn.init.xavier_uniform_(cls_w, generator=generator)
