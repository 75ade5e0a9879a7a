"""The device trace's arithmetic on a recorded event list: busy time,
kernel time, top operations and idle gaps named by the host's spans."""

from types import SimpleNamespace as NS

import pytest

from gdb_bench.trace import MARKER, DeviceTrace, Spans


def _ev(name, dev, start_us, end_us, annotation=False):
    return NS(name=name, device_type=NS(name=dev),
              time_range=NS(start=start_us, end=end_us),
              is_user_annotation=annotation)


def test_device_trace_skips_annotations_and_names_gaps():
    events = [
        _ev(MARKER, "CPU", 1_000, 11_000, True),
        _ev(MARKER, "CUDA", 1_000, 11_000, True),     # the mirror
        _ev("kernel_a", "CUDA", 2_000, 3_000),
        _ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 2_500, 4_000),
        _ev("kernel_b", "CUDA", 8_000, 8_500),
    ]
    prof = NS(events=lambda: events)
    # the marker opened at host time 100.001 s, the window 100.001-100.011
    trace = DeviceTrace(prof, 100.001, (100.001, 100.011))
    assert trace.window_s == pytest.approx(0.010)
    assert trace.busy_s() == pytest.approx(0.0025)     # 2.0-4.0, 8.0-8.5 ms
    assert trace.kernel_s() == pytest.approx(0.0015)   # copies excluded
    assert [n for n, _ in trace.top_ops()][0] == \
        "Memcpy HtoD (Pageable -> Device)"
    spans = Spans()
    spans.add("store_to_block", 100.0045, 100.0075)
    gaps = trace.idle_gaps(spans)
    assert gaps[0] == ["store_to_block", pytest.approx(0.004)]
    assert {g[0] for g in gaps} == {"store_to_block", "host"}
