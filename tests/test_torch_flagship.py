"""PyTorch port, the rest of the flagship model on the CPU, against the JAX
package on JAX weights bridged by ``from_jax_variables``:

* gem_r50 with ``dilation_block5=True, stem_s2d=True``: masked-bucket
  extraction against the JAX model's at 1e-4 (the golden bar), and
  against the port's own exact-shape run at the bar of
  ``tests/test_masked_extract.py`` (2e-5); the dilated identity blocks
  run the module form, so one pass calls the bottleneck kernel's wrapper
  10 times, not 12; layer4 keeps layer3's resolution.
* gem_r101 at 32 px against the JAX model at 1e-4; its 29 identity
  blocks go through the wrapper.
* The key sets: a JAX gem_r101 and a dilated, space-to-depth gem_r50
  convert with no flax leaf left over and no port key missing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
    stage_extents,
)
from research_image_retrieval_tpu_torch.models import backbone as tbackbone
from test_torch_bf16 import _fill_variables
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
FLAGS = dict(dilation_block5=True, stem_s2d=True)


def _shapes(jm):
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))


def _bridged(name, **kw):
    jm = jax_get_model(name, num_classes=8, outputdim=64, **kw)
    variables = _fill_variables(_shapes(jm), 3)
    port = get_model(name, num_classes=8, outputdim=64, **kw)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, port.eval()


@pytest.fixture()
def count_wrapper(monkeypatch):
    """Calls of the bottleneck kernel's wrapper from the backbone (on the
    CPU the wrapper runs the plain version and its launch count stays 0,
    so the calls are counted here)."""
    calls = []
    real = tbackbone.fused_bottleneck

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tbackbone, "fused_bottleneck", counted)
    return calls


def test_dilated_s2d_gem_r50_matches_jax(count_wrapper):
    jm, variables, port = _bridged("gem_r50", **FLAGS)
    rng = np.random.default_rng(4)
    sizes = [(64, 64), (45, 37)]
    imgs = [rng.standard_normal((h, w, 3)).astype(np.float32)
            for h, w in sizes]
    padded = np.zeros((2, 64, 64, 3), np.float32)
    for i, img in enumerate(imgs):
        padded[i, :img.shape[0], :img.shape[1]] = img
    ext = np.asarray(sizes, np.int32)
    want = np.asarray(jm.apply(variables, jnp.asarray(padded),
                               jnp.asarray(ext), method="extract"))
    with torch.no_grad():
        got = port.extract(T(padded), T(ext)).numpy()
        assert len(count_wrapper) == 10  # 12 identity blocks, 2 dilated
        exact = [port.extract(T(img[None])).numpy()[0] for img in imgs]
        fmap = port.backbone(T(padded[:1]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for i in range(2):
        assert np.abs(got[i] - exact[i]).max() <= 2e-5
    assert fmap.shape[1:3] == (4, 4)  # stride 16: layer4 not halved
    assert stage_extents(T(ext), 5, True).tolist() == [[4, 4], [3, 3]]
    layer4 = port.backbone.layer4
    assert [b.conv2.dilation[0] for b in layer4] == [1, 2, 2]
    assert [b.fusable for b in layer4] == [False, False, False]


def test_gem_r101_matches_jax(count_wrapper):
    jm, variables, port = _bridged("gem_r101")
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), method="extract"))
    with torch.no_grad():
        got = port.extract(T(x)).numpy()
    assert len(count_wrapper) == 29
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _leaves(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name, kw", [("gem_r101", {}), ("gem_r50", FLAGS)])
def test_jax_key_sets_convert_whole(name, kw):
    """Every flax leaf becomes one port tensor and the port has no key
    the conversion did not fill (``num_batches_tracked`` aside)."""
    jm = jax_get_model(name, num_classes=8, **kw)
    variables = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                             dict(_shapes(jm)))
    sd = from_jax_variables(variables)
    assert len(sd) == _leaves(variables)
    port = get_model(name, num_classes=8, **kw)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    assert "conv1" in variables["params"]["backbone"]  # the s2d stem's path
