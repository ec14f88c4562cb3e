"""The reduction of the program's spans on synthetic profiler events:
device operations go to the innermost stage span around their launch (a
sweep nested in stage 1 keeps its own), waits and syncs to their sites,
and the split adds up to ``core/trace.py``'s device time; the counter
reader reads nothing where the program has no grid counters."""
import sys
import types
from types import SimpleNamespace

import pytest
from conftest import REPO

from cardbench.core import spans, trace
from cardbench.core.spans import Event
from cardbench.core.specs import Specs


def host(name, s, e, corr=0):
    return Event(name, False, s, e, corr=corr)


def dev(name, s, e, corr=0, link=0, annotation=False):
    return Event(name, True, s, e, corr=corr, link=link,
                 annotation=annotation)


K = "void at::native::vectorized_elementwise_kernel<4>(int)"
EVENTS = [
    host(trace.CALL_SPAN, 0, 100), host(trace.CALL_SPAN, 100, 200),
    # Call 1: a closest hit, its stages, a wait and a nested sweep.
    host("raycore.closest_hit", 1, 99),
    host("raycore.stage1", 2, 40),
    host("raycore.wait.worklist", 10, 20),
    host("raycore.sweep", 25, 35),
    host("raycore.sweep", 41, 60),
    host("raycore.combine", 61, 70),
    host("raycore.finalize", 71, 98),
    # Launched in stage 1, and inside its wait: both stage 1's.
    host("cudaLaunchKernel", 5, 6, corr=1), dev(K, 6, 9, corr=1),
    host("aten::nonzero", 11, 19, corr=40),
    host("cudaMemcpyAsync", 12, 13, corr=2),
    dev("Memcpy DtoH (Device -> Pinned)", 13, 14, corr=2, link=40),
    host("cudaStreamSynchronize", 14, 18),
    # The wave sweep nested in stage 1, then the sweep of stage 2.
    host("cudaLaunchKernel", 26, 27, corr=3),
    dev("regroup_sweep_kernel(int const*)", 27, 34, corr=3),
    host("cudaLaunchKernel", 42, 43, corr=4),
    dev("regroup_sweep_kernel(int const*)", 43, 58, corr=4),
    # The combine's kernel found by its linked host operation alone.
    host("aten::scatter_reduce", 62, 64, corr=50),
    dev(K, 64, 68, corr=999, link=50),
    # The finalize's kernel with no link: its span's device annotation.
    dev("raycore.finalize", 72, 97, annotation=True),
    dev(K, 80, 90),
    # Launched after the query's root: no span.
    host("cudaLaunchKernel", 99.2, 99.4, corr=7),
    dev(K, 99.5, 99.9, corr=7),
    # Call 2: a refresh with its upload, then a sync in no wait span.
    host("raycore.refresh", 101, 120),
    host("raycore.wait.transforms", 102, 105),
    host("cudaStreamSynchronize", 103, 104),
    host("cudaLaunchKernel", 110, 111, corr=8), dev(K, 111, 115, corr=8),
    host("raycore.any_hit", 121, 189),
    host("raycore.stage1", 122, 140),
    host("cudaStreamSynchronize", 130, 131),
    # The harness's own sync is no site; a device event past the span is
    # left out, as are device annotations and sync records.
    host(trace.SYNC_SPAN, 190, 199),
    host("cudaDeviceSynchronize", 191, 198),
    dev(K, 300, 310, corr=9),
    dev("raycore.stage1", 122, 140, annotation=True),
    dev("Event Sync", 150, 160),
]


def test_operations_go_to_the_innermost_stage_of_their_launch():
    s = spans.reduce(EVENTS)
    assert s.calls == 2
    assert s.ops == {"raycore.stage1": 2, "raycore.sweep": 2,
                     "raycore.combine": 1, "raycore.finalize": 1,
                     "raycore.refresh": 1}
    assert s.device_s["raycore.stage1"] == pytest.approx((3 + 1) * 1e-6)
    # The nested wave sweep is the sweep's, not stage 1's.
    assert s.device_s["raycore.sweep"] == pytest.approx((7 + 15) * 1e-6)
    assert s.device_s["raycore.combine"] == pytest.approx(4e-6)
    assert s.device_s["raycore.finalize"] == pytest.approx(10e-6)
    assert s.unattributed_ops == 1
    assert s.unattributed_s == pytest.approx(0.4e-6)
    # Every operation but the finalize's carries a link.
    assert s.linked_ops == 7
    assert s.stage_ms(spans.STAGE1) == pytest.approx(4e-3 / 2)
    assert s.stage_ops(spans.STAGE1) == 1.0


def test_device_time_adds_up_to_the_trace_reduction():
    s = spans.reduce(EVENTS)
    t = trace.summarize(spans.to_trace(EVENTS))
    assert t.own_s + t.library_s == pytest.approx(
        sum(s.device_s.values()) + s.unattributed_s)


def test_waits_and_syncs_by_site():
    s = spans.reduce(EVENTS)
    assert s.host_s["raycore.wait.worklist"] == pytest.approx(10e-6)
    assert s.wait_ms == pytest.approx((10 + 3) * 1e-3 / 2)
    assert s.syncs == {"raycore.wait.worklist": 1,
                       "raycore.wait.transforms": 1, "raycore.stage1": 1}
    assert sum(s.syncs.values()) == trace.summarize(
        spans.to_trace(EVENTS)).syncs
    unnamed = spans.unnamed_syncs(EVENTS)
    assert [(u[0], u[1]) for u in unnamed] == [(130, "raycore.stage1")]


def test_idle_gaps_by_span_add_up():
    s = spans.reduce(EVENTS)
    t = trace.summarize(spans.to_trace(EVENTS))
    assert sum(s.idle_s.values()) == pytest.approx(t.window_s - t.busy_s)
    # Each gap goes to the innermost span over its middle: 9-13 to the
    # wait, 0-6, 14-27 and 34-43 to stage 1, 115-200 to the any_hit root.
    assert s.idle_s["raycore.wait.worklist"] == pytest.approx(4e-6)
    assert s.idle_s["raycore.stage1"] == pytest.approx((6 + 13 + 9) * 1e-6)
    assert s.idle_s["raycore.any_hit"] == pytest.approx(85e-6)
    assert spans.OUTSIDE not in s.idle_s


def test_a_trace_without_calls_is_refused():
    with pytest.raises(ValueError):
        spans.reduce([host("raycore.stage1", 0, 1)])


@pytest.fixture
def reader():
    return Specs([REPO]).module("metrics", "sweep_fill_pct.frame").read


def _program(monkeypatch, **counters):
    pack = types.SimpleNamespace(**counters)
    mod = types.ModuleType("raycore_tpu_torch.ops.regroup")
    mod.pack_presorted_cluster_major = pack
    monkeypatch.setitem(sys.modules, "raycore_tpu_torch.ops.regroup", mod)


@pytest.mark.parametrize("counters", [{}, {"slots": 0, "filled": 0}],
                         ids=["no counters", "no slots"])
def test_the_fill_reader_reads_nothing_without_slots(monkeypatch, reader,
                                                     counters):
    _program(monkeypatch, **counters)
    assert reader(SimpleNamespace(trace=object())) is None


def test_the_fill_reader_reads_the_live_share(monkeypatch, reader):
    _program(monkeypatch, slots=400, filled=317)
    assert reader(SimpleNamespace(trace=object())) == pytest.approx(79.25)
    assert reader(SimpleNamespace(trace=None)) is None
