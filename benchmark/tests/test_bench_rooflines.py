"""``mvdr_roofline.bulk`` and ``covprefix_roofline.bulk``: the least time
of the MVDR solve and of the covariance prefixes over their kernels'
device time, against traces and least times worked by hand at config4's
and em32's shapes."""

import pytest

import roofline
from harness import cells, runner
from harness.trace import Trace

MVDR = cells.reader("mvdr_roofline.bulk")
COV = cells.reader("covprefix_roofline.bulk")
NS = "(anonymous namespace)::"
# the kernels of a bulk call beside the ones each reader counts
OTHERS = [(NS + "srp_fused_kernel(float2 const*, int const*)", 0.0,
           900.0),
          ("mcax::tc::sum_partials_kernel(float const*)", 900.0, 950.0),
          (NS + "stft_fft_blocks_kernel(float const*)", 950.0, 990.0),
          (NS + "track_scan_kernel(float const*)", 990.0, 995.0)]


def _run(config, traffic, kernels, calls):
    return runner.Run(cell={}, config=cells.config(config),
                      traffic=cells.traffic(traffic), calls=calls,
                      samples=0, window_s=0, setup_s=0, series={},
                      traces=[Trace((0.0, 1e9), OTHERS + kernels, [])])


def _calls(names_us, calls):
    """``calls`` calls 1000 ms apart, each running the (name, us) kernels
    one after the other from 1000 us into the call."""
    out = []
    for i in range(calls):
        t = 1e6 * i + 1000.0
        for name, us in names_us:
            out.append((name, t, t + us))
            t += us
    return out


def test_mvdr_least_times_by_hand():
    # config4: B = 512, F = 513, C = 8, one look: bytes
    t, by = roofline.mvdr(512, 513, 8, 512 * 8 * 513)
    assert by == "bytes"
    assert t == pytest.approx((4.0 * 512 * 64 * 513 + 16.0 * 512 * 8 * 513)
                              / 3.35e12) == pytest.approx(3.0107e-5,
                                                          rel=1e-4)
    # em32: C = 32, two sources: operations
    t, by = roofline.mvdr(512, 513, 32, 512 * 2 * 32 * 513)
    assert by == "operations"
    assert t == pytest.approx(512 * 513 * (4.0 * 32 ** 3 + 16.0 * 32 ** 2)
                              / 67e12) == pytest.approx(5.7805e-4, rel=1e-4)


@pytest.mark.parametrize("config,traffic,kernels,least", [
    # config4: kernel 4 one thread a system, 45 us a call
    ("config4", "bulk.static",
     [(NS + "mvdr_solve_kernel(float const*, float2*)", 45.0)], 3.0107e-5),
    # config5: the group body at C = 16 and the block step's solve
    ("config5", "bulk.moving",
     [(NS + "mvdr_group_kernel<16, (anonymous namespace)::RowsLoader<16, "
       "32> >(float const*)", 400.0),
      (NS + "mvdr_group_kernel<16, (anonymous namespace)::ComplexRows<16> "
       ">(float2 const*)", 20.0)],
     max(512 * 257 * (4.0 * 16 ** 3 + 16.0 * 16 ** 2) / 67e12,
         (4.0 * 512 * 256 * 257 + 16.0 * 512 * 2 * 16 * 257) / 3.35e12)),
    # em32: C = 32, runs of 8 systems, 6.3 ms a call
    ("locata_em32", "bulk.moving",
     [(NS + "mvdr_group_kernel<32, (anonymous namespace)::RowsLoader<32, "
       "8> >(float const*)", 6300.0)], 5.7805e-4),
])
def test_mvdr_roofline_reader(config, traffic, kernels, least):
    calls = 3
    got = MVDR(_run(config, traffic, _calls(kernels, calls), calls))
    device_s = sum(us for _, us in kernels) * 1e-6
    assert got == pytest.approx(100.0 * least / device_s, rel=1e-4)
    assert 0.0 < got < 100.0


def test_cov_least_times_by_hand():
    # config4 and em32, B = 512, T = 24, F = 513: bytes at both
    for c in (8, 32):
        t, by = roofline.cov_prefixes(c, 512, 24, 513)
        assert by == "bytes"
        assert t == pytest.approx(
            (8.0 * c * 512 * 24 * 513 + 8.0 * 513 * c * c
             + 8.0 * 512 * c * c * 513) / 3.35e12)


@pytest.mark.parametrize("config,traffic,kernels,c,t,f", [
    ("config4", "bulk.static",
     [(NS + "cov_partials_kernel<8, 8>(float2 const*)", 270.0),
      (NS + "cov_carries_kernel(float*)", 20.0),
      (NS + "cov_fixup_kernel(float*)", 100.0)], 8, 24, 513),
    ("locata_em32", "bulk.moving",
     [(NS + "cov_partials_kernel<32, 32>(float2 const*)", 6030.0),
      (NS + "cov_carries_kernel(float*)", 190.0),
      (NS + "cov_fixup_kernel(float*)", 1710.0)], 32, 24, 513),
])
def test_covprefix_roofline_reader(config, traffic, kernels, c, t, f):
    calls = 4
    got = COV(_run(config, traffic, _calls(kernels, calls), calls))
    least = (8.0 * c * 512 * t * f + 8.0 * f * c * c
             + 8.0 * 512 * c * c * f) / 3.35e12
    device_s = sum(us for _, us in kernels) * 1e-6
    assert got == pytest.approx(100.0 * least / device_s, rel=1e-6)
    assert 0.0 < got < 100.0


@pytest.mark.parametrize("read", [MVDR, COV])
def test_nothing_to_read_without_their_kernels(read):
    """No trace, or a trace of the other kernels alone (none whose name
    holds one of the reader's), reads None."""
    assert read(_run("locata_em32", "bulk.moving", [], 2)) is None
    assert read(runner.Run(cell={}, config=cells.config("config4"),
                           traffic=cells.traffic("bulk.static"), calls=1,
                           samples=0, window_s=1.0, setup_s=0.0,
                           series={})) is None


def test_each_reader_counts_its_own_kernels_alone():
    """The solve's kernels move only the MVDR share, kernel 3's only the
    covariance share."""
    solve = [(NS + "mvdr_solve_kernel(float const*, float2*)", 45.0)]
    prefixes = [(NS + "cov_partials_kernel<8, 8>(float2 const*)", 270.0),
                (NS + "cov_carries_kernel(float*)", 20.0),
                (NS + "cov_fixup_kernel(float*)", 100.0)]
    both = _run("config4", "bulk.static", _calls(solve + prefixes, 2), 2)
    assert MVDR(both) == pytest.approx(
        MVDR(_run("config4", "bulk.static", _calls(solve, 2), 2)))
    assert COV(both) == pytest.approx(
        COV(_run("config4", "bulk.static", _calls(prefixes, 2), 2)))
