"""The yardstick's arithmetic against numbers worked by hand."""
from __future__ import annotations

import pytest

from perfbench import common, flops
from perfbench.reference import model

MISTRAL = common.load_json(common.ROOT / "configs" /
                           "mistral-nemo-12b-4l.json")
GRANITE = common.load_json(common.ROOT / "configs" /
                           "granite-moe-1b-a400m.json")
H100 = flops.peak("NVIDIA H100 80GB HBM3")


def test_active_params_by_hand():
    # Mistral: 4 x (5120 x 4096 x 2 + 5120 x 1024 x 2 + 3 x 5120 x 14336)
    # + the head 5120 x 131072
    assert model.active_params(MISTRAL) == \
        4 * (41_943_040 + 10_485_760 + 220_200_960) + 671_088_640
    # Granite: 24 x (1024 x 1024 x 2 + 1024 x 512 x 2 + 8 x 3 x 1024 x 512
    # + the router 1024 x 32) + the tied head 1024 x 49280
    assert model.active_params(GRANITE) == \
        24 * (2_097_152 + 1_048_576 + 12_582_912 + 32_768) + 50_462_720


def test_train_step_flops_by_hand():
    # 6 x 1,761,607,680 x 8,192 + 6 x 4 x 2 x 32 x 4,096^2 x 128
    assert flops.train_step_flops(MISTRAL, 2, 4096) == pytest.approx(
        86_586_540_687_360 + 3_298_534_883_328, rel=1e-12)
    # 6 x 428,736,512 x 16,384 + 6 x 24 x 4 x 16 x 4,096^2 x 64
    assert flops.train_step_flops(GRANITE, 4, 4096) == pytest.approx(
        42_146_514_075_648 + 9_895_604_649_984, rel=1e-12)


def test_prefill_flops_by_hand():
    # 2 x 1,090,519,040 x 8 x 8,192 + 2 x 671,088,640 x 8
    # + 2 x 4 x 8 x 32 x 128 x 8,192^2
    assert flops.prefill_flops(MISTRAL, 8, 8192) == pytest.approx(
        142_936_511_610_880 + 10_737_418_240 + 17_592_186_044_416,
        rel=1e-12)


def test_flash_bound_by_hand():
    f, b = flops.flash_work(MISTRAL, 8, 8192)
    # 4 x 8 x 32 x 128 x 8192 x 8193 / 2; bf16 q, k, v, o: 2 x 8 x 8192 x
    # 128 x (32 + 8 + 8 + 32)
    assert f == 4 * 8 * 32 * 128 * 8192 * 8193 / 2
    assert b == 2 * 8 * 8192 * 128 * 80
    assert flops.bound_s(f, b, H100) == pytest.approx(f / 989e12)
    # a short sequence is bound by its bytes
    f, b = flops.flash_work(MISTRAL, 1, 16)
    assert flops.bound_s(f, b, H100) == pytest.approx(b / 3.35e12)


def test_peak_table():
    assert H100["bf16_flops_per_s"] == 989e12
    assert flops.peak("cpu") is None
