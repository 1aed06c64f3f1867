"""The benchmark's arithmetic: window rates, percentiles over all requests,
the idle share from a union of device intervals, roofline shares, and the
per-layer readers on a made-up trace."""

import statistics

import numpy as np
import pytest

from portbench.harness import readers, stats, work
from portbench.harness.context import Outcome
from portbench.harness.trace import Trace


def test_window_rate_is_all_work_over_all_time():
    assert stats.window_rate(10752 * 96, 20.25) == pytest.approx(10752 * 96 / 20.25)
    with pytest.raises(ValueError):
        stats.window_rate(1, 0.0)


@pytest.mark.parametrize("pct", [50, 95, 99])
def test_percentile_over_every_request_matches_numpy(pct):
    values = list(np.random.default_rng(pct).gamma(3.0, 25.0, size=263))
    assert stats.percentile(values, pct) == pytest.approx(np.percentile(values, pct))


def test_percentile_is_not_a_median_of_chunks():
    values = [1.0] * 90 + [100.0] * 10
    chunks = [stats.percentile(values[i::4], 95) for i in range(4)]
    assert stats.percentile(values, 95) == 100.0
    assert statistics.median(chunks) != pytest.approx(stats.percentile(values, 50))


def test_union_counts_overlapping_work_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert stats.union_length([]) == 0.0


def test_idle_share():
    assert stats.idle_share(0.6, 0.8) == pytest.approx(25.0)


def test_roofline_share_takes_the_larger_bound():
    # compute bound: 989 GFLOP in 2 ms at 989 TFLOP/s peak -> 50%
    assert stats.roofline_pct(989e9, 1.0, 2e-3, 989e12, 3.35e12) == pytest.approx(50.0)
    # memory bound: 3.35 GB in 4 ms -> 25%
    assert stats.roofline_pct(1.0, 3.35e9, 4e-3, 989e12, 3.35e12) == pytest.approx(25.0)
    assert stats.roofline_pct(1.0, 1.0, 0.0, 1.0, 1.0) is None


def test_spread_is_the_interquartile_distance_over_the_median():
    v = [100.0, 101.0, 99.0, 100.5, 99.5, 100.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def _outcome(trace=None, **context):
    out = Outcome(setup_s=1.0, attempted=1, failed=0, trace=trace)
    out.context.update(context)
    return out


def test_readers_on_a_made_up_trace():
    trace = Trace(kernels_s={"void (anonymous namespace)::conv3x3_tma_kernel<1>(x)": 0.012,
                             "void field_mlp_fwd_kernel(Args)": 0.006,
                             "void at::native::reduce_kernel<512, 1>(x)": 0.018},
                  busy_s=0.036, wall_s=0.040, units=6)
    out = _outcome(trace)
    assert readers.torch_kernels_ms(out) == pytest.approx(3.0)
    assert readers.device_idle_pct(out) == pytest.approx(10.0)
    share = readers.share_of_bound(out, 1e-3, [r"conv3x3_(tma|legacy)_kernel"])
    assert share == pytest.approx(100.0 * 1e-3 / (0.012 / 6))
    assert readers.share_of_bound(out, 1e-3, [r"no_such_kernel"]) is None
    assert readers.torch_kernels_ms(_outcome()) is None


def test_the_port_kernel_names_come_from_its_sources():
    names = readers.port_kernel_names()
    assert {"conv3x3_tma_kernel", "field_mlp_fwd_kernel", "pdf_resample_kernel",
            "rows_sum_kernel", "upsample_bwd_kernel"} <= names
    assert "__launch_bounds__" not in names
    assert readers.is_port_kernel("void (anonymous namespace)::wgb::field_mlp_dw_kernel(x)")
    assert not readers.is_port_kernel("void at::native::reduce_kernel<128, 4>(x)")


def test_mfu_is_the_windows_operations_over_its_time_at_peak():
    out = _outcome(calls=10, call_flops=9.0e12, window_s=2.0)
    assert readers.mfu_pct(out, work.PEAK_BF16_FLOPS) == pytest.approx(
        100.0 * 9.0e13 / (2.0 * 989e12))
    assert readers.mfu_pct(_outcome(), work.PEAK_BF16_FLOPS) is None
