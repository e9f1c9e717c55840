"""The roofline's arithmetic on worked shapes."""

import pytest

from perfbench import roofline

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_ten_million_rows_thirty_two_queries_is_bytes_bound():
    # 10M x 256 f32 = 10.24 GB; 32 queries; 320 hits
    b = roofline.scan_bytes(10_000_000, 256, 32, 320)
    assert b == 10_240_000_000 + 32_768 + 3_840
    s, bound = roofline.least_seconds(10_000_000, 256, 32, 320, H100)
    assert bound == "bytes" and s == pytest.approx(b / 3.35e12)
    assert s == pytest.approx(3.0568e-3, rel=1e-4)


def test_a_thousand_queries_over_a_million_rows_is_flops_bound():
    f = roofline.scan_flops(1_000_000, 256, 1000)
    assert f == 512_000_000_000
    s, bound = roofline.least_seconds(1_000_000, 256, 1000, 10_000, H100)
    assert bound == "flops" and s == pytest.approx(f / 67e12)
    assert s == pytest.approx(7.6418e-3, rel=1e-4)


def test_unknown_card_has_no_peaks():
    assert roofline.peaks("cpu") is None
