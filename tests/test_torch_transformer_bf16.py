"""PyTorch port, the transformer families at bf16 compute dtype on the
CPU against JAX's bf16 models on the same seeded weights (the tiny
configs and buckets of ``tests/test_torch_transformer.py``): ULTRON, ViT
and CLIP (the ViT tower, and the ModifiedResNet tower with its attention
pool).

The rule is ``tests/test_torch_bf16.py``'s: JAX's own bf16 floor is JAX
against itself with the (bf16) input moved by one bf16 ulp up and down,
and the port's descriptors must lie within 3x that floor of JAX's, on
the exact-shape call and on the masked bucket.  CLIP's attention pool
adds the position embedding in fp32 where JAX adds it in the tower's
dtype (ROADMAP Queue 3): that rounding is held by the same bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from test_torch_bf16 import bumps
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_transformer import (
    CASES,
    bucket,
    jax_model,
    overrides,
    port_model,
)

T = torch.from_numpy


@pytest.mark.parametrize("kind", list(CASES))
def test_transformer_bf16_extract_matches_jax(kind):
    _, variables = jax_model(kind)
    jm = jmodels.get_model(CASES[kind][0],
                           **overrides(kind, dtype=jnp.bfloat16))
    port = port_model(kind, variables, dtype="bfloat16").eval()
    x, ext = bucket(kind)

    @jax.jit
    def jext(x):
        return (jm.apply(variables, x, method="extract"),
                jm.apply(variables, x, jnp.asarray(ext), method="extract"))

    want = [np.asarray(w) for w in jext(jnp.asarray(x))]
    moved = [[np.asarray(w) for w in jext(jnp.asarray(b))] for b in bumps(x)]
    with torch.no_grad():
        got = [port.extract(T(x)).float().numpy(),
               port.extract(T(x), T(ext)).float().numpy()]
    for i, what in enumerate(("extract", "masked")):
        floor = max(np.abs(m[i] - want[i]).max() for m in moved)
        dev = np.abs(got[i] - want[i]).max()
        assert np.isfinite(want[i]).all() and floor > 0, what
        assert dev <= 3 * floor, (what, dev, floor)
