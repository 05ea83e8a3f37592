"""The copied yardstick against the numbers it was copied with: the f32
kernel's bound at 256 and 4096 rows in ``PERF.md``'s kernel table, and
config 6's FLOPs a training step."""
import math

import pytest

from portbench.harness import tracesum
from portbench.harness.yardstick import (
    bound,
    f32_accurate_peak,
    idle_gaps,
    peaks,
    percentile,
    train_gemm_bound_s,
    train_gemm_flops_per_step,
    union_seconds,
    wide_train_flops_per_step,
)

WIDTHS = (1, 1024, 1024, 1024, 1)
SXM = peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("rows, ms, by", [(256, 0.0065, "operations"),
                                          (4096, 0.1042, "operations")])
def test_the_f32_kernel_bound_is_the_kernel_tables(rows, ms, by):
    got, what = bound(rows, WIDTHS, "kernel", SXM)
    assert round(got, 4) == ms and what == by


def test_the_f32_accurate_peak_is_3xtf32_on_the_sxm_part():
    assert f32_accurate_peak(SXM) == pytest.approx(165e12)
    assert peaks("NVIDIA H100 PCIe")["part"] == "H100 PCIe"


def test_config_6_flops_a_step():
    # bench.py's wide_train_flops_per_step() at WIDE_BATCH, WIDE_FEATURES, WIDE_HIDDEN
    fwd = 2.0 * 8192 * (32 * 1024 + 1024 * 1024 * 2 + 1024)
    assert wide_train_flops_per_step(8192, 32, (1024, 1024, 1024)) == 3 * fwd
    assert wide_train_flops_per_step(8192, 32, (1024, 1024, 1024)) == pytest.approx(104.74e9,
                                                                                  rel=1e-3)
    # the products autograd runs: the first layer's input gradient is not one
    assert train_gemm_flops_per_step(8192, 32, (1024, 1024, 1024)) == 3 * fwd - 2.0 * 8192 * 32 * 1024


def test_the_gemm_bound_is_the_operations_at_the_peak_for_wide_layers():
    t = train_gemm_bound_s(8192, 32, (1024, 1024, 1024), SXM)
    ops_only = train_gemm_flops_per_step(8192, 32, (1024, 1024, 1024)) / 165e12
    assert ops_only <= t <= 1.1 * ops_only


def test_percentile_counts_a_failed_request_as_missing():
    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert math.isinf(percentile([1.0] * 90 + [math.inf] * 10, 95))


def test_busy_time_and_gaps():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert union_seconds(intervals, 0.0, 5.0) == 3.0
    assert union_seconds(intervals, 1.5, 3.5) == 1.0
    assert idle_gaps(intervals, 0.0, 5.0) == [(2.0, 1.0), (4.0, 1.0)]
    trace = {"t0": 0.0, "t1": 5.0, "events": [["a", 0.0, 1.0], ["b", 0.5, 2.0],
                                               ["a", 3.0, 4.0]]}
    assert tracesum.busy_window(trace) == (3.0, 5.0)
    assert tracesum.seconds_by_name(trace) == {"a": (2.0, 2), "b": (1.5, 1)}
    summary = tracesum.breakdown(trace)
    assert summary["device_ops"][0] == ["a", 2.0]
    assert summary["idle_gaps"][0] == ["b -> a", 1.0]
