"""Byte counts at the launch shapes the main path logged on the card, and
the reading of a profiler trace."""

import pytest

from gjbench import roofline
from gjbench.devtrace import DeviceTrace, short_name
from gjbench.window import Window


class Span:
    def __init__(self, name, t0, t1, **args):
        self.name, self.t0, self.t1, self.args = name, t0, t1, args

    @property
    def seconds(self):
        return self.t1 - self.t0


@pytest.mark.parametrize("k, runs, total, bound_ms", [
    (7, 19_280_906, 735_987_655, 6.3357),     # lastfm_A2, generation
    (6, 1_004_489, 38_344_764, 0.2831),       # lastfm_A1, generation
    (2, 1_004_489, 38_344_764, 0.0952),       # lastfm_A1, desummarize
    (4, 1_892, 72_137, 0.0004),
])
def test_expand_many_bytes_at_logged_shapes(k, runs, total, bound_ms):
    nbytes = roofline.expand_many_bytes(k, runs, total)
    assert nbytes == (k * total + k * runs + runs) * 4
    assert nbytes / roofline.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(bound_ms, abs=5e-5)


def test_expand_many_bytes_of_the_a2_launch():
    assert roofline.expand_many_bytes(7, 19_280_906, 735_987_655) == \
        21_224_643_332


@pytest.mark.parametrize("n, segments, bound_ms", [
    (38_344_764, 10_737, 0.2289), (38_344_764, 1_004_489, 0.2313),
    (1_004_489, 659_379, 0.0076)])
def test_mul_segsum_bytes_at_logged_shapes(n, segments, bound_ms):
    nbytes = roofline.mul_segsum_bytes(n, segments)
    assert nbytes / roofline.HBM_BYTES_PER_S * 1e3 == \
        pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("raw, short", [
    ("void (anonymous namespace)::expand_many_kernel(int const*, int const*,"
     " int, long long, int, int*)", "expand_many_kernel"),
    ("void (anonymous namespace)::segsum_pass<long long, false>(int const*)",
     "segsum_pass"),
    ("_ZN47_GLOBAL__N__0ce77544_14_expand_many_cu_9afd6eed18expand_many_"
     "kernelEPKiS1_ixiPi", "expand_many_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<int> >(int)", "at::native::vectorized_elementwise_kernel"),
])
def test_kernel_names(raw, short):
    assert short_name(raw) == short


def trace(window_us=(1000.0, 2000.0)):
    t0, t1 = window_us
    return [
        {"name": "gjbench:window", "ph": "X", "ts": t0, "dur": t1 - t0,
         "cat": "user_annotation"},
        {"name": "void (anonymous namespace)::expand_many_kernel(int)",
         "ph": "X", "cat": "kernel", "ts": 1100.0, "dur": 100.0},
        {"name": "Memcpy DtoH (Device -> Pinned)", "ph": "X",
         "cat": "gpu_memcpy", "ts": 1150.0, "dur": 150.0},
        {"name": "void (anonymous namespace)::expand_many_kernel(int)",
         "ph": "X", "cat": "kernel", "ts": 1900.0, "dur": 200.0},
        {"name": "before", "ph": "X", "cat": "kernel", "ts": 10.0,
         "dur": 50.0},
    ]


def test_busy_time_is_the_union_of_device_intervals_inside_the_window():
    dt = DeviceTrace(trace(), host_t0=5.0)
    # [1100, 1300) and [1900, 2000) of a 1,000 us window
    assert dt.busy_s == pytest.approx(300e-6)
    assert dt.window_s == pytest.approx(1e-3)
    assert dt.kernel_seconds("expand_many_kernel") == pytest.approx(200e-6)
    ops = dict(dt.device_ops())
    assert ops["Memcpy DtoH (Device -> Pinned)"] == pytest.approx(150e-6)


def test_idle_gaps_are_named_by_the_innermost_host_span():
    dt = DeviceTrace(trace(), host_t0=5.0)
    spans = [Span("gjbench:query", 5.0, 5.001),
             Span("plan:search", 5.0003, 5.0009)]
    gaps = dict(dt.idle_gaps(spans))
    assert gaps["plan:search"] == pytest.approx(600e-6)
    assert gaps["gjbench:query"] == pytest.approx(100e-6)


def test_roofline_share_from_spans_and_kernel_time():
    dt = DeviceTrace(trace(), host_t0=5.0)
    k, runs, total = 4, 1000, 10_000_000
    w = Window(5.0, 5.001, [], 0.0, 0,
               [Span("kernel:rle_expand_many", 5.0001, 5.0002, k=k,
                     runs=runs, total=total)], dt)
    want = 100 * roofline.expand_many_bytes(k, runs, total) / \
        roofline.HBM_BYTES_PER_S / 200e-6
    assert roofline.share("expand_many", w) == pytest.approx(want)
    assert roofline.share("mul_segsum", w) is None
    assert roofline.share("expand_many", Window(0, 1, [], 0)) is None
