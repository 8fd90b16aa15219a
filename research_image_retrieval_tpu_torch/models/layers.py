"""Shared transformer building blocks of the model zoo
(port of ``research_image_retrieval_tpu/models/layers.py``), plus the
flax-semantics normalizations and the dropout the zoo's heads use.

* ``Attention`` — separate q/k/v projections, scale ``head_dim^-0.5``,
  padded keys masked with ``ops/masking.mask_attn_logits``; the output
  projection is zero-initialized so each residual branch starts as the
  identity.
* ``Encoder`` — self-attention, then flax BN over the tokens and one
  Linear as the MLP, both residual.
* ``Decoder`` — LN -> cross-attention -> MLP -> LN -> self-attention,
  all residual.
* ``Mlp`` (exact GELU) and ``DropPath`` (stochastic depth).
* ``LayerNorm`` — flax's: ``var = max(E[x^2] - E[x]^2, 0)`` (its
  ``use_fast_variance`` default), ``y = (x - mean) * (rsqrt(var + eps) *
  scale) + bias``; a bf16 input is normalized in fp32 and rounded back.
* ``Dense`` — flax ``nn.Dense(dtype=...)``: a Linear computing in its
  input's dtype (fp32 parameters cast to it).
* ``MultiHeadAttention`` — flax ``nn.MultiHeadDotProductAttention``
  (self-attention, or cross-attention over ``kv`` tokens;
  ``query`` / ``key`` / ``value`` / ``out`` with biases,
  the first three ``[heads, head_dim]`` as flax keeps them,
  the query divided by ``sqrt(head_dim)``, padded keys at the dtype's
  lowest value, the softmax in fp32) of the transformer towers.
* ``TokenBatchNorm`` — flax ``nn.BatchNorm`` of a ``[B, N, D]`` tensor
  over (B, N): the backbone's ``BatchNorm`` on a ``[B, D, N, 1]`` view,
  so the biased running variance and ``E[x^2] - E[x]^2`` carry over.
* ``dropout`` — drops from an explicit ``torch.Generator`` (the train
  step's, drawn once per step from the train state's stream), so a
  seeded or resumed run repeats; its bits are not flax's.

All ops are batch-first ``[B, N, D]`` and run in fp32 with TF32 off
(the towers' blocks in their model's compute dtype).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import BatchNorm
from research_image_retrieval_tpu_torch.ops.masking import mask_attn_logits
from research_image_retrieval_tpu_torch.ops.norm import at_least_fp32
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["Attention", "Decoder", "Dense", "DropPath", "Encoder", "LayerNorm",
           "Mlp", "MultiHeadAttention", "TokenBatchNorm", "dropout"]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """``x * (u >= rate) / (1 - rate)``, ``u`` uniform from ``generator``
    (on ``x``'s device) in training with ``rate > 0``; else ``x``.  A
    training call that drops needs a generator: there is no hidden
    global random state."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator "
                         "(the train step passes its own)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (``weight`` = its
    ``scale``), computed as flax computes it (see the module
    docstring)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_fp32(x)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (flax ``nn.Dense(
    dtype=...)``: a bf16 input multiplies the bf16-cast weight with fp32
    accumulation and gives bf16).  A bias may keep a ``DenseGeneral``'s
    ``[heads, head_dim]`` shape."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else \
            self.bias.reshape(-1).to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over ``[B, N, dim]`` queries
    (``qkv_features = out_features = dim``), self-attention or, with
    ``kv`` [B, Nk, dim], cross-attention (flax's ``inputs_k = inputs_v``).  The
    projections run in the input's dtype; the logits are taken to fp32
    for the mask and the softmax (flax's ``force_fp32_for_softmax``), and
    the probabilities return to the input's dtype for the values."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)
        for proj in (self.query, self.key, self.value):
            # flax's shape, so the rank > 1 decay mask takes them as JAX's
            proj.bias = nn.Parameter(torch.zeros(num_heads, dim // num_heads))

    @fp32_precision()
    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None,
                causal: bool = False,
                kv: torch.Tensor | None = None) -> torch.Tensor:
        """``key_mask`` [B, Nk] (1 = real token) removes padded keys from
        every query's softmax; ``causal`` lets token i see keys <= i;
        ``kv`` gives the keys' and values' tokens (default ``x``)."""
        B, N, _ = x.shape
        h = self.num_heads
        hd = self.dim // h
        kv = x if kv is None else kv

        def heads(t):
            return t.reshape(B, t.shape[1], h, hd).transpose(1, 2)

        q = heads(self.query(x)) / torch.sqrt(
            torch.tensor(float(hd), dtype=x.dtype, device=x.device))
        logits = torch.matmul(q, heads(self.key(kv)).transpose(-1, -2))
        logits = at_least_fp32(logits)
        low = torch.finfo(logits.dtype).min
        if key_mask is not None:
            logits = torch.where(key_mask.bool()[:, None, None, :], logits,
                                 low)
        if causal:
            tri = torch.ones(N, N, dtype=torch.bool, device=x.device).tril()
            logits = torch.where(tri, logits, low)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(attn, heads(self.value(kv)))
        return self.out(out.transpose(1, 2).reshape(B, N, self.dim))


class TokenBatchNorm(BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` of ``[B, N, D]``
    tokens, normalizing over (B, N) (a ``BatchNorm1d`` of the flattened
    tokens, with flax's statistics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [B, N, D] -> [B, D, N, 1]: a channels_last view, no copy
        y = super().forward(x.transpose(1, 2)[..., None])
        return y[..., 0].transpose(1, 2)


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return x / keep * mask


class Mlp(nn.Module):
    """Linear -> GELU (exact) -> dropout -> Linear -> dropout."""

    def __init__(self, in_dim: int, hidden: int, out: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.drop = drop

    @fp32_precision()
    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = F.gelu(self.fc1(x), approximate="none")
        x = dropout(x, self.drop, self.training, generator)
        return dropout(self.fc2(x), self.drop, self.training, generator)


class Attention(nn.Module):
    """Multi-head attention with separate q/k/v inputs (``q_dim`` /
    ``kv_dim``: their widths, default ``dim``)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 q_dim: int | None = None, kv_dim: int | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.q = nn.Linear(q_dim or dim, dim, bias=qkv_bias)
        self.k = nn.Linear(kv_dim or dim, dim, bias=qkv_bias)
        self.v = nn.Linear(kv_dim or dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj.zero_init = True  # training_init keeps it zero
        nn.init.zeros_(self.proj.weight)
        if qkv_bias:
            nn.init.zeros_(self.proj.bias)

    @fp32_precision()
    def forward(self, q, k, v, key_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """q [B, Nq, q_dim], k and v [B, Nk, kv_dim] -> [B, Nq, dim];
        ``key_mask`` [B, Nk] removes pad keys from every softmax."""
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        h = self.num_heads
        hd = self.dim // h

        def heads(t, n):
            return t.reshape(B, n, h, hd).transpose(1, 2)

        qh, kh, vh = heads(self.q(q), Nq), heads(self.k(k), Nk), \
            heads(self.v(v), Nk)
        attn = torch.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
        if key_mask is not None:
            attn = mask_attn_logits(attn, key_mask)
        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop,
                       self.training, generator)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Nq, self.dim)
        return dropout(self.proj(out), self.proj_drop, self.training,
                       generator)


class Encoder(nn.Module):
    """Self-attention encoder block with token BatchNorm; BN reads batch
    statistics in train mode and the running ones in eval mode."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.dp = DropPath(drop_path)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop)
        self.bn = TokenBatchNorm(dim)
        self.mlp = nn.Linear(dim, dim)

    @fp32_precision()
    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        a = self.attn(x, x, x, key_mask=key_mask, generator=generator)
        x = x + self.dp(a, generator)
        return x + self.dp(self.mlp(self.bn(x)), generator)


class Decoder(nn.Module):
    """Cross + self attention decoder block (``kv_dim``: the width of
    the attended tokens, default ``dim``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, kv_dim: int | None = None):
        super().__init__()
        self.dp = DropPath(drop_path)
        self.cross_attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                                    kv_dim=kv_dim)
        self.self_attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop)
        self.mlp = Mlp(dim, 2 * dim, dim, drop)
        self.bn1 = LayerNorm(dim)
        self.bn2 = LayerNorm(dim)

    @fp32_precision()
    def forward(self, q: torch.Tensor, x: torch.Tensor,
                key_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        g = generator
        q = q + self.dp(self.cross_attn(self.bn1(q), x, x, key_mask=key_mask,
                                        generator=g), g)
        q = q + self.dp(self.mlp(q, g), g)
        q_bn = self.bn2(q)
        return q + self.dp(self.self_attn(q_bn, q_bn, q_bn, generator=g), g)
