"""The arithmetic of the metrics, against numbers worked by hand."""

import math

import pytest

import roofline
from harness import cells, runner
from harness.trace import Trace, breakdown, gaps, host_op_at, union_us


def test_percentile_over_all_samples():
    read = cells.reader("block_p95_ms")
    run = runner.Run(cell={}, config={}, traffic={}, calls=100,
                     samples=0, window_s=1.0, setup_s=0.0,
                     series={"latency_ms": [float(v)
                                            for v in range(100, 0, -1)]})
    # inclusive method: 1 + 0.95 * 99 = 95.05th smallest
    assert read(run) == pytest.approx(95.05)


def test_union_counts_an_overlap_of_two_streams_once():
    # two streams: [0, 10) and [5, 20) overlap on [5, 10); [30, 40) apart
    assert union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert union_us([(5, 20), (0, 10), (12, 15)]) == 20
    assert gaps([(0, 10), (5, 20), (30, 40)], 0, 50) == [(20, 30), (40, 50)]


def test_idle_share_of_a_window():
    tr = Trace(window=(0.0, 100.0),
               device=[("a", 0.0, 40.0), ("b", 20.0, 50.0),
                       ("c", 90.0, 120.0)],
               host=[("outer", 0.0, 100.0), ("inner", 55.0, 80.0)])
    assert tr.busy_s() == pytest.approx(60e-6)        # 50 + 10 clipped
    run = runner.Run(cell={}, config={}, traffic={}, calls=1,
                     samples=0, window_s=0, setup_s=0, series={},
                     traces=[tr, tr])
    assert cells.reader("idle_share.bulk")(run) == pytest.approx(40.0)
    assert host_op_at(sorted(tr.host, key=lambda h: h[1]), 70.0) == "inner"
    bd = breakdown(tr)
    assert bd["idle_gaps"][0] == ["inner", pytest.approx(40e-6)]
    assert bd["device_ops"][0] == ["a", pytest.approx(40e-6)]


def test_srp_least_time_config4_and_config5():
    # config4 B = 512: M = 12 288 frames, G = 360, P = 28, F = 513
    ops4 = 4 * 12288 * 360 * 28 * 513            # 2.5417e11
    t4, by4 = roofline.srp(12288, 360, 28, 513, 8)
    assert by4 == "operations"
    assert t4 == pytest.approx(ops4 / 165e12) == pytest.approx(1.5404e-3,
                                                                rel=1e-4)
    # config5 B = 512: M = 8192, G = 360, P = 120, F = 257
    t5, by5 = roofline.srp(8192, 360, 120, 257, 16)
    assert by5 == "operations"
    assert t5 == pytest.approx(3.6379e11 / 165e12, rel=1e-4)


def test_srp_roofline_reader():
    cfg = cells.config("config4")
    kernels = [("(anonymous namespace)::srp_fused_kernel(float2 const*)",
                i * 8000.0, i * 8000.0 + 6000.0) for i in range(3)]
    kernels += [("mcax::tc::sum_partials_kernel(float const*)",
                 i * 8000.0 + 6000.0, i * 8000.0 + 6750.0) for i in range(3)]
    kernels += [("stft_fft_blocks_kernel", 7000.0, 7400.0)]
    run = runner.Run(cell={}, config=cfg,
                     traffic=cells.traffic("bulk.static"), calls=3,
                     samples=0, window_s=0, setup_s=0, series={},
                     traces=[Trace((0.0, 24000.0), kernels,
                                                 [])])
    least = 4 * 12288 * 360 * 28 * 513 / 165e12
    assert cells.reader("srp_roofline.bulk")(run) == pytest.approx(
        100 * least / 6.75e-3)


def test_other_least_times():
    t, by = roofline.stft(12288 * 8, 1024, 513, 8 * 512 * 12288)
    assert by == "bytes"
    assert t == pytest.approx((4.0 * (8 * 512 * 12288 + 1024)
                               + 8.0 * 12288 * 8 * 513) / 3.35e12)
    t, by = roofline.cov_prefixes(8, 512, 24, 513)
    assert t == pytest.approx(max(8.0 * 512 * 64 * 24 * 513 / 67e12,
                                  (8.0 * 8 * 512 * 24 * 513 + 8.0 * 513 * 64
                                   + 8.0 * 512 * 64 * 513) / 3.35e12))
    assert math.isclose(roofline.FP32_ACCURATE_TC_FLOPS, 165e12)
    assert roofline.card_line().startswith("peaks (H100 SXM at 700 W)")
