"""Card-only tests of the port's training path (skipped without a CUDA
device).  On the card:

    python -m pytest --noconftest tests/test_torch_cuda_train.py -q

* one train step of GeM-R50 (batch 2, 128 px, 512 classes) on CUDA
  equals the same step on the CPU from the same state in float64, at the
  fixed bars of ``train.device_check.BARS`` (loss and grad_norm 1e-10,
  each gradient leaf 1e-8, each parameter's change 1e-6, running
  statistics 1e-9), and in float32 TF32 is off while autograd runs the
  backward, with the caller's flags restored after the step;
* the eval step on CUDA (the bottleneck kernel in the identity blocks)
  equals the CPU's (the kernels' plain versions) on the same weights.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_train_step_cuda_equals_cpu(cuda):
    from research_image_retrieval_tpu_torch.train.device_check import (
        BARS,
        check_cuda_train_step,
    )

    checks = check_cuda_train_step()
    assert set(checks) == set(BARS)
    for name, (dev, bar, leaf) in checks.items():
        assert dev <= bar, (name, dev, leaf)


def test_eval_step_cuda_equals_cpu(cuda):
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.models import get_model
    from research_image_retrieval_tpu_torch.ops import resblock
    from research_image_retrieval_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_sgd_optimizer,
    )

    state = create_train_state(get_model("gem_r50", num_classes=64), 3,
                               make_sgd_optimizer(0.1), "cpu")
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    y = rng.integers(0, 64, 4)
    ev = make_eval_step((IMAGENET_MEAN, IMAGENET_STD))
    want = ev(state, x, y)
    gpu = create_train_state(get_model("gem_r50", num_classes=64), 3,
                             make_sgd_optimizer(0.1), "cuda")
    before = resblock.fused_bottleneck.launches
    got = ev(gpu, x, y)
    torch.cuda.synchronize()
    assert resblock.fused_bottleneck.launches > before
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    assert float(got["top1_err"]) == float(want["top1_err"])
