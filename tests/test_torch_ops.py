"""PyTorch port, descriptor ops: each against its JAX function on the same
numpy inputs (CPU), plus the rule that the port imports no JAX.

Tolerances: the ops are elementwise or short fp32 reductions, so the two
frameworks agree to a few ULP; 1e-6 (absolute, on O(1) values) is stated
per test.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.ops import masking as jmask
from research_image_retrieval_tpu.ops import norm as jnorm
from research_image_retrieval_tpu.ops import pooling as jpool
from research_image_retrieval_tpu.ops import resize as jresize
from research_image_retrieval_tpu_torch.ops import masking, norm, pooling, resize
from test_torch_model import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_l2_normalize_matches_jax(rng):
    x = rng.standard_normal((5, 33)).astype(np.float32)
    x[2] = 0.0  # zero rows map to zero, not NaN
    want = np.asarray(jnorm.l2_normalize(jnp.asarray(x)))
    got = norm.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[2] == 0)


def test_fused_input_norm_matches_jax(rng):
    x = rng.integers(0, 256, (2, 7, 5, 3), dtype=np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    want = np.asarray(jnorm.fused_input_norm((mean, std))(jnp.asarray(x)))
    got = norm.fused_input_norm((mean, std))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ident = norm.fused_input_norm(None)
    t = torch.ones(1)
    assert ident(t) is t


def test_masking_matches_jax(rng):
    ext = rng.integers(0, 40, (6, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        masking.ceil_half(torch.from_numpy(ext)).numpy(),
        np.asarray(jmask.ceil_half(jnp.asarray(ext))))
    np.testing.assert_array_equal(
        masking.downsample_extents(torch.from_numpy(ext), 5).numpy(),
        np.asarray(jmask.downsample_extents(jnp.asarray(ext), 5)))
    np.testing.assert_array_equal(
        masking.hw_mask(13, 17, torch.from_numpy(ext)).numpy(),
        np.asarray(jmask.hw_mask(13, 17, jnp.asarray(ext))))


@pytest.mark.parametrize("antialias", [True, False])
def test_dense_resize_weights_matches_jax(antialias):
    in_sz = np.array([40, 33, 17, 9], np.int32)
    out_sz = np.array([28, 33, 40, 5], np.int32)
    want = np.asarray(jresize.dense_resize_weights(
        jnp.asarray(in_sz), jnp.asarray(out_sz), 48, 44, antialias=antialias))
    got = resize.dense_resize_weights(
        torch.from_numpy(in_sz), torch.from_numpy(out_sz), 48, 44,
        antialias=antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_gem_pool_matches_jax(rng, masked):
    x = rng.standard_normal((3, 6, 7, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.uniform(size=(3, 6, 7)) > 0.4).astype(np.float32)
        mask[1] = 0.0  # an all-padding image: count floors at 1
    want = np.asarray(jpool.gem_pool(
        jnp.asarray(x), p=3.0,
        valid_hw=None if mask is None else jnp.asarray(mask)))
    got = pooling.gem_pool(
        torch.from_numpy(x), p=3.0,
        valid_hw=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gem_pool_learnable_p_tensor(rng):
    x = np.abs(rng.standard_normal((2, 4, 4, 8))).astype(np.float32)
    want = np.asarray(jpool.gem_pool(jnp.asarray(x),
                                     p=jnp.asarray([2.5], jnp.float32)))
    got = pooling.gem_pool(torch.from_numpy(x), p=torch.tensor([2.5])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


_BANNED = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|tools|tests|"
    r"research_image_retrieval_tpu)(\s|\.|$)", re.M)


def test_port_imports_no_jax_source_scan():
    """No import of jax, the JAX package, tools/ or tests/ in the port's
    sources or chip_smoke.py (the test files may import both)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    pkg = os.path.join(ROOT, "research_image_retrieval_tpu_torch")
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    offenders = [f for f in files if _BANNED.search(open(f).read())]
    assert not offenders, offenders


def test_port_imports_no_jax_at_runtime():
    """Importing every port module (the serving stack, the training
    stack, the zoo models and the CLIs included) with jax and the JAX
    package blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'research_image_retrieval_tpu', 'tools'):\n"
        "    sys.modules[m] = None\n"
        "import research_image_retrieval_tpu_torch.ops\n"
        "import research_image_retrieval_tpu_torch.models\n"
        "import research_image_retrieval_tpu_torch.index\n"
        "import research_image_retrieval_tpu_torch.evaluation\n"
        "import research_image_retrieval_tpu_torch.data\n"
        "import research_image_retrieval_tpu_torch.serve\n"
        "import research_image_retrieval_tpu_torch.cli.evaluate\n"
        "import research_image_retrieval_tpu_torch.cli.extract\n"
        "import research_image_retrieval_tpu_torch.cli.search\n"
        "import research_image_retrieval_tpu_torch.cli.serve\n"
        "import research_image_retrieval_tpu_torch.cli.train\n"
        "import research_image_retrieval_tpu_torch.cli.pack\n"
        "import research_image_retrieval_tpu_torch.train\n"
        "import research_image_retrieval_tpu_torch.train.driver\n"
        "import research_image_retrieval_tpu_torch.models.dolg\n"
        "import research_image_retrieval_tpu_torch.models.solar\n"
        "import research_image_retrieval_tpu_torch.models.delg\n"
        "import research_image_retrieval_tpu_torch.index.rerank\n"
        "import chip_smoke\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
