"""The least-time arithmetic at known shapes."""

import pytest

from portbench.roofline import least_time_s, search_work

INT8 = {"scan": "int8", "rescore": "bfloat16", "candidates": 100}
BF16 = {"scan": "bfloat16"}


def test_int8_b1_is_bound_by_bytes_at_2_32_ms():
    # 10M x 768 int8 rows, scales and bias, the query and 100 bf16 rows gathered
    assert least_time_s(INT8, 10_000_000, 768, 1, 100) * 1e3 == pytest.approx(2.3165, abs=1e-3)


def test_bf16_b256_is_bound_by_bytes_at_4_59_ms():
    nbytes, op_s = search_work(BF16, 5_000_000, 1536, 256, 100)
    assert op_s * 1e3 == pytest.approx(3.976, abs=1e-3)   # one bf16 product at 989 TFLOP/s
    assert least_time_s(BF16, 5_000_000, 1536, 256, 100) * 1e3 == pytest.approx(4.5916, abs=1e-3)


def test_int8_products_count_at_the_int8_peak():
    nbytes, op_s = search_work(INT8, 10_000_000, 768, 1024, 100)
    assert op_s == pytest.approx(2 * 1024 * 10_000_000 * 768 / 1979e12
                                 + 2 * 1024 * 100 * 768 / 989e12)
    assert least_time_s(INT8, 10_000_000, 768, 1024, 100) == pytest.approx(op_s)


@pytest.mark.parametrize("scoring", [INT8, BF16], ids=["int8", "bf16"])
def test_padding_adds_work(scoring):
    assert least_time_s(scoring, 10**6, 768, 256, 100) > least_time_s(scoring, 10**6, 768, 64, 100)
