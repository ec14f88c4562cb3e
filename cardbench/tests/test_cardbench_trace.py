"""The trace reduction on synthetic profiler events: the idle union, the
split of device time between the port's kernels and the libraries', and
the host-sync count."""
import pytest

from cardbench.core import trace
from cardbench.core.trace import Event


def host(name, s, e):
    return Event(name, False, s, e)


def dev(name, s, e):
    return Event(name, True, s, e)


EVENTS = [
    host(trace.CALL_SPAN, 0, 100), host(trace.CALL_SPAN, 100, 200),
    # The port's kernels (anonymous namespace) and library kernels.
    dev("(anonymous namespace)::regroup_sweep_kernel(int const*)", 10, 30),
    dev("void at::native::vectorized_elementwise_kernel<4>(int)", 25, 40),
    dev("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>()",
        50, 60),
    dev("Memcpy DtoH (Device -> Pageable)", 60, 62),
    dev("phase_a_kernel(float const*)", 110, 150),
    dev("Memset (Device)", 150, 151),
    # A device event past the traced span is left out.
    dev("phase_a_kernel(float const*)", 300, 310),
    # Host syncs: an item() enclosing a memcpy and a stream sync counts
    # once; a bare stream sync once; the harness's sync not at all.
    host("aten::item", 40, 63), host("aten::_local_scalar_dense", 41, 63),
    host("cudaStreamSynchronize", 45, 62),
    host("cudaStreamSynchronize", 70, 75),
    host(trace.SYNC_SPAN, 160, 200), host("cudaDeviceSynchronize", 161, 199),
    host("aten::nonzero", 80, 105),
    # A synchronous copy counts where a device-to-host memcpy runs
    # inside it, and not where the copy goes to the device.
    host("cudaMemcpy", 120, 130), dev("Memcpy DtoH (Device -> Pinned)",
                                      121, 122),
    host("cudaMemcpy", 135, 140), dev("Memcpy HtoD (Pinned -> Device)",
                                      136, 137),
    # A wait on an event is not among the listed syncs.
    host("cudaEventSynchronize", 141, 145),
]


def test_idle_is_the_span_outside_the_device_union():
    s = trace.summarize(EVENTS)
    # Union: [10, 40] + [50, 62] + [110, 151] = 30 + 12 + 41 = 83 us
    # (the copies at 121 and 136 lie inside it).
    assert s.busy_s == pytest.approx(83e-6)
    assert s.window_s == pytest.approx(200e-6)
    assert s.idle_pct == pytest.approx(100 * (1 - 83 / 200))
    assert s.calls == 2


def test_own_kernels_and_library_time():
    s = trace.summarize(EVENTS)
    assert s.own_s == pytest.approx((20 + 40) * 1e-6)
    assert s.library_s == pytest.approx((15 + 10 + 2 + 1 + 1 + 1) * 1e-6)
    assert s.per_call_ms(s.own_s) == pytest.approx(0.03)
    assert trace.is_library("ampere_sgemm_128x64_nn")
    assert trace.is_library("void cutlass::Kernel2<cutlass_80_tensorop>()")
    assert not trace.is_library("worklist_sweep_kernel(int const*)")


def test_syncs_count_once_each_and_skip_the_harness():
    # item() with its nested copy and sync, the bare stream sync, and the
    # device-to-host cudaMemcpy.
    assert trace.summarize(EVENTS).syncs == 3


def test_breakdown_names_ops_and_gaps():
    s = trace.summarize(EVENTS)
    assert s.device_ops[0] == ["phase_a_kernel", pytest.approx(40e-6)]
    names = dict(s.idle_gaps)
    # The gap 62-110 lies mostly in aten::nonzero (80-105) at its midpoint.
    assert names["aten::nonzero"] == pytest.approx(48e-6)
    assert len(s.device_ops) <= trace.TOP and len(s.idle_gaps) <= trace.TOP


def test_short_names_drop_templates_and_parameters():
    assert trace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int, float)") == \
        "at::native::vectorized_elementwise_kernel"
