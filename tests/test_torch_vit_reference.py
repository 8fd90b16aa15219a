"""PyTorch port, ViT global descriptor against the benchmark's plain
reference (``perfbench/reference/vit.py``), on the CPU at a tiny
variant (the ViT-B/16 cell runs at its published widths on the card
only):

* ``extract_vectors`` through ``_make_extract_fn`` (padded buckets,
  extents snapped to the patch, three scales on the device path) equals
  the reference's image-by-image descriptors on seeded weights, and the
  TF32 control does not;
* the benchmark's operation counts against a hand count;
* the cell end to end through ``perfbench.harness.run_cell``, traced.
"""

import math

import numpy as np
import torch

from perfbench import control_vit, harness, inputs, inputs_vit, work_vit
from perfbench.drivers import extract_vit
from perfbench.reference import vit as ref
from research_image_retrieval_tpu_torch.evaluation.driver import (
    _make_extract_fn,
)
from research_image_retrieval_tpu_torch.index import extract_vectors
from test_torch_model import few_torch_threads  # noqa: F401

CELL = "vit_b16.index_vit_1024_ms3"
# the port's "test" variant; a 4 x 4 native position grid
TINY_CFG = {"variant": "test", "dim": 32, "depth": 2, "heads": 2, "patch": 8,
            "mlp": 128, "img_size": 32, "outputdim": 16, "num_classes": 16}
TINY = {"config": TINY_CFG,
        "traffic": {"pool": 8, "longest": 96, "bucket": 32, "batch": 4,
                    "stretch_at": 0.0, "stretch_s": 0.3}}
SCALES = (1.0, 2 ** -0.5, 0.5)
# unaligned sides (snapped to 8); (90, 43) keeps only its first scale
SIZES = [(96, 72), (72, 96), (61, 90), (90, 43), (50, 50)]
# fp32 round-off of the padded, batched, flax-LayerNorm program against
# the unpadded two-pass reference: a few ulps of unit-vector components
# (~6e-8 each); the TF32 control reads 4e-4 to 7e-4 here
TOL = 5e-6


def _config():
    return harness.make_cell(CELL, 0, 0.0, False, device="cpu",
                             overrides=TINY)[0].config


def _images(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in SIZES]


def test_extract_vectors_matches_the_reference():
    cfg = _config()
    weights = inputs_vit.vit_weights(cfg, 11, "cpu")
    model = extract_vit.port_model(cfg, weights, torch.device("cpu"))
    fn, bucket, multiple = _make_extract_fn(model, bucket=32)
    assert multiple == cfg["patch"] == 8
    norm = (np.array(inputs.IMAGENET_MEAN, np.float32),
            np.array(inputs.IMAGENET_STD, np.float32))
    got = extract_vectors(fn, iter(_images()), scales=SCALES, bucket=bucket,
                          batch_size=2, device_scales=True, input_norm=norm,
                          extent_multiple=multiple, device="cpu")
    want = ref.descriptors(_images(), weights, cfg, SCALES,
                           inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, "cpu")
    assert got.shape == want.shape == (len(SIZES), 16)
    np.testing.assert_allclose(np.linalg.norm(want, axis=1), 1.0, atol=1e-6)
    assert np.abs(got - want).max() < TOL
    ctrl = ref.descriptors(_images(), weights, cfg, SCALES,
                           inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, "cpu",
                           precision="tf32")
    assert np.abs(ctrl - want).max() > 20 * TOL


def test_task_sizes_snap_as_the_port_does():
    assert ref.task_size(90, 43, 1.0, 8) == (88, 40)
    assert ref.task_size(90, 43, 2 ** -0.5, 8) is None      # 30 px < 36
    assert ref.task_size(716, 1024, 1.0, 16) == (720, 1024)
    assert ref.task_size(1024, 768, 2 ** -0.5, 16) == (720, 544)
    assert ref.snap(4, 8) == 8 and ref.snap(12, 8) == 16  # 1.5 -> 2


def test_operation_counts_by_hand():
    cfg = {"dim": 768, "depth": 12, "heads": 12, "patch": 16, "mlp": 3072,
           "outputdim": 768}
    # 1024 x 768: 64 x 48 = 3072 patches, N = 3073 tokens
    d, n = 768, 3073
    patch = 3072 * 768 * 3 * 16 * 16 * 2
    qkvo = 4 * n * d * d * 2
    mlp = 2 * n * d * 3072 * 2
    products = 2 * n * n * d * 2
    head = 1536 * 768 * 2
    want = patch + 12 * (qkvo + mlp + products) + head
    assert work_vit.vit_ops(cfg, 1024, 768) == want
    assert want == 873_753_513_984
    ops, nbytes = work_vit.attention_call_work([3073, 1531], 768)
    assert ops == sum(4 * t * d * d * 2 + 2 * t * t * d * 2
                      for t in (3073, 1531))
    assert nbytes == 4 * (2 * (3073 + 1531) * d + 4 * d * d + 4 * d)


def test_the_cell_end_to_end_traced():
    r = harness.run_cell(CELL, 2 ** 33 + 41, 0.6, True, device="cpu",
                         overrides=TINY)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 0
    assert 0.0 <= dev["busy_s"] <= dev["window_s"]
    # the CPU has no device trace: the card's two metrics are left out
    assert set(r["metrics"]) == {"mfu.index_vit",
                                 "vit.pair_valid_share.index_vit"}
    share = r["metrics"]["vit.pair_valid_share.index_vit"]["value"]
    assert 0.0 < share < 100.0
    c = r["checks"]["desc_max_abs"]
    assert c["value"] <= c["limit"]


def test_the_control_is_not_correct():
    limit = harness.make_cell(CELL, 0, 0.0, False, device="cpu")[0] \
        .limits["desc_max_abs"]
    got = control_vit.readings(CELL, 2 ** 33 + 43, device="cpu",
                               overrides=TINY)
    assert not (math.isfinite(got["desc_max_abs"])
                and got["desc_max_abs"] <= limit), got
