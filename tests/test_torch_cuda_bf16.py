"""Card-only tests of the port's bf16 path and exact resume (skipped
without a CUDA device).  On the card:

    python -m pytest --noconftest tests/test_torch_cuda_bf16.py -q

* the bottleneck kernel's bf16 form against its plain version at bf16 on
  the same inputs, with and without extents, at ragged rows: within one
  bf16 ulp of the largest |out| (both sum fp32 products of the same bf16
  values, in other orders, and round t1, t2 and the output to bf16: an
  order-level difference moves a rounding of t1 or t2 by one ulp, which
  carries through the next sums, where an output can be far smaller than
  its terms, so the bar scales with the outputs' range, not each
  element), and the kernel's error against the fp32 plain version no
  worse than 1.5x the bf16 plain version's own; a dtype other than fp32
  or bf16 raises;
* the head on a bf16 map against its plain version: rtol 1e-5 / atol
  1e-6 (both pool the upcast map in fp32);
* the eval step of a bf16 model on CUDA (the bf16 kernels in its
  identity blocks) against the CPU's on the same weights: loss within
  1e-2 relative (cuDNN and oneDNN round their bf16 convolutions after
  sums in other orders);
* ``cli.train`` stopped at step 3 of 16 (a preemption checkpoint, mid
  epoch) and resumed with ``--resume latest`` equals the straight run
  bit for bit (model, optimizer state), fp32 and bf16, inside
  ``deterministic_mode()`` in a process started with
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from research_image_retrieval_tpu_torch.ops import gem_head, resblock

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _block(g, B, H, W, C, Cw):
    x = torch.relu(torch.randn(B, H, W, C, device="cuda", generator=g))
    w1 = torch.randn(C, Cw, device="cuda", generator=g) / C ** 0.5
    w2 = torch.randn(3, 3, Cw, Cw, device="cuda", generator=g) / (9 * Cw) ** 0.5
    w3 = torch.randn(Cw, C, device="cuda", generator=g) / Cw ** 0.5

    def sb(n):
        return torch.stack([1 + 0.1 * torch.randn(n, device="cuda", generator=g),
                            0.1 * torch.randn(n, device="cuda", generator=g)])

    return x, (w1, sb(Cw), w2, sb(Cw), w3, sb(C))


def _ulp(v):
    a = v.abs().double().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("B, H, W, C, Cw, ext", [
    (2, 16, 16, 256, 64, None),
    (2, 13, 19, 256, 64, [[10, 19], [13, 7]]),
    (3, 7, 9, 512, 128, None),
    (2, 32, 32, 1024, 256, [[30, 32], [32, 17]]),
    (2, 16, 16, 2048, 512, None),
])
def test_bottleneck_bf16_kernel(cuda, B, H, W, C, Cw, ext):
    x, ws = _block(cuda, B, H, W, C, Cw)
    e = (None if ext is None
         else torch.tensor(ext, dtype=torch.int32, device="cuda"))
    xb = x.to(torch.bfloat16)
    before = resblock.fused_bottleneck.launches
    got = resblock.fused_bottleneck(xb, *ws, extents=e)
    torch.cuda.synchronize()
    assert resblock.fused_bottleneck.launches == before + 1
    assert got.dtype == torch.bfloat16
    plain = resblock.fused_bottleneck_reference(xb, *ws, extents=e)
    f32 = resblock.fused_bottleneck_reference(x, *ws, extents=e)
    diff = (got.double() - plain.double()).abs().max()
    assert diff <= _ulp(plain.abs().max()), diff
    err_kernel = (got.double() - f32.double()).abs().max().item()
    err_plain = (plain.double() - f32.double()).abs().max().item()
    assert err_kernel <= 1.5 * err_plain, (err_kernel, err_plain)


def test_bottleneck_other_dtype_raises(cuda):
    x, ws = _block(cuda, 1, 4, 4, 256, 64)
    with pytest.raises(ValueError, match="dtype"):
        resblock.fused_bottleneck(x.half(), *ws)


@pytest.mark.parametrize("ext", [None, [[9, 7], [4, 3], [1, 7]]])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_gem_head_bf16_map(cuda, ext, wdt):
    g = cuda
    fmap = torch.randn(3, 9, 7, 256, device="cuda",
                       generator=g).abs().to(torch.bfloat16)
    weight = torch.randn(96, 256, device="cuda", generator=g) / 16
    bias = 0.01 * torch.randn(96, device="cuda", generator=g)
    kw = ({} if ext is None else
          {"extents": torch.tensor(ext, dtype=torch.int32, device="cuda")})
    got = gem_head.gem_whiten_l2(fmap, weight, bias, weight_dtype=wdt, **kw)
    want = gem_head.gem_whiten_l2_reference(fmap, weight, bias,
                                            weight_dtype=wdt, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_bf16_eval_step_cuda_equals_cpu(cuda):
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.models import get_model
    from research_image_retrieval_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_sgd_optimizer,
    )

    def state(dev):
        return create_train_state(
            get_model("gem_r50", num_classes=64, dtype="bfloat16"), 3,
            make_sgd_optimizer(0.1), dev)

    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    y = rng.integers(0, 64, 4)
    ev = make_eval_step((IMAGENET_MEAN, IMAGENET_STD))
    want = ev(state("cpu"), x, y)
    before = resblock.fused_bottleneck.launches
    got = ev(state("cuda"), x, y)
    torch.cuda.synchronize()
    assert resblock.fused_bottleneck.launches == before + 12
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-2)


_RESUME = textwrap.dedent("""
    import os, sys, torch
    sys.path.insert(0, {root!r})
    from research_image_retrieval_tpu_torch.cli.train import main
    from research_image_retrieval_tpu_torch.train import driver as drv
    from research_image_retrieval_tpu_torch.train.preemption import (
        PreemptionGuard)
    from research_image_retrieval_tpu_torch.utils.profiling import (
        deterministic_mode)
    work, dtype, device = sys.argv[1:4]
    # the synthetic classes: 256 images, 8 steps per epoch
    args = ["--imsize", "64", "--batch-size", "32", "--num-epochs", "2",
            "--num-workers", "4", "--save-freq", "1", "--dtype", dtype,
            "--device", device]
    a, b = os.path.join(work, "a"), os.path.join(work, "b")

    class StopAtStep3(PreemptionGuard):  # as a SIGTERM at step 3 would
        def __init__(self):
            super().__init__(signals=())
            self.seen = 0

        @property
        def should_stop(self):
            self.seen += 1
            if self.seen >= 3:
                self.request_stop()
            return super().should_stop

    with deterministic_mode():
        main(args + ["--directory", a])
        drv.PreemptionGuard = StopAtStep3
        main(args + ["--directory", b])
        drv.PreemptionGuard = PreemptionGuard
        main(args + ["--directory", b, "--resume", "latest"])
    pa = torch.load(os.path.join(a, "epoch_00002.pt"), weights_only=False)
    pb = torch.load(os.path.join(b, "epoch_00002.pt"), weights_only=False)
    for k, v in pa["model"].items():
        assert torch.equal(v, pb["model"][k]), k
    sa, sb = pa["optimizer"]["inner"]["state"], pb["optimizer"]["inner"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert pa["step"] == pb["step"] == 16
    print("RESUME EQUAL")
""")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_train_resume_bit_exact(cuda, tmp_path, dtype):
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run(
        [sys.executable, "-c", _RESUME.format(root=ROOT), str(tmp_path),
         dtype, "cuda"], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "RESUME EQUAL" in out.stdout
