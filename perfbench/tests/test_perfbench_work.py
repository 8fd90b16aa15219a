"""The yardstick's operation and byte counts against published and hand
counts."""

import pytest

from perfbench import work


@pytest.mark.parametrize("arch,v15,paper", [("resnet50", 4.1e9, 3.8e9),
                                            ("resnet101", 7.8e9, 7.6e9)])
def test_resnet_macs_at_224_match_the_published_counts(arch, v15, paper):
    # He et al. (2016) give 3.8 and 7.6 billion multiply-adds with the
    # stride on the first 1x1; torchvision's v1.5 (stride on the 3x3, the
    # form the port builds) reads 4.1 and 7.8; both with the 1000-way fc
    assert work.resnet_macs(arch, 224, 224, fc=1000) == \
        pytest.approx(v15, rel=0.015)
    assert work.resnet_macs(arch, 224, 224, fc=1000,
                            stride_on_conv1=True) == pytest.approx(paper,
                                                                   rel=0.02)


def test_resnet_macs_follow_the_odd_sizes_of_torch_padding():
    # 225 px: the stem gives 113, the pool 57, the stages 57, 29, 15, 8
    odd = work.resnet_macs("resnet50", 225, 225)
    even = work.resnet_macs("resnet50", 224, 224)
    assert odd > even
    assert work.resnet_macs("resnet50", 64, 96) == \
        work.resnet_macs("resnet50", 64, 96)


def test_bottleneck_valid_rows_by_hand():
    # one layer3 identity block (C = 1024, Cw = 256) over two images whose
    # extents at that stage are 48 x 64 and 30 x 64: 4992 valid rows
    rows = 48 * 64 + 30 * 64
    ops, nbytes = work.bottleneck_call_work(rows, 1024)
    per_row = 1024 * 256 + 9 * 256 * 256 + 256 * 1024
    assert ops == 2 * rows * per_row
    weights = per_row
    assert nbytes == 4 * (2 * rows * 1024 + weights + 2 * (256 + 256 + 1024))


def test_roofline_takes_the_larger_bound():
    ops, nbytes = 165e12, 1.0
    assert work.roofline_s(ops, nbytes) == pytest.approx(
        ops / work.PEAKS["fp32_tc"])
    assert work.roofline_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_retrieval_and_step_counts():
    from perfbench.drivers.train import step_ops

    cfg = {"depths": [3, 4, 6, 3], "outputdim": 2048, "num_classes": 81313}
    mix = {"batch": 128, "image_size": 512}
    fwd = work.resnet_macs("resnet50", 512, 512) + 2048 * 2048 \
        + 2048 * 81313
    assert step_ops(cfg, mix) == 2 * 3 * 128 * fwd
