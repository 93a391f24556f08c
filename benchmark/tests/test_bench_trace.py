"""The trace reduction on a made-up timeline: busy time merged over
overlaps, idle gaps named by the innermost host event at their middle,
mirrored host spans and the profiler's own events left out."""

from __future__ import annotations

import pytest

from benchmark.harness import trace


class Ev:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


class Prof:
    def __init__(self, events):
        class R:
            def events(self_inner):
                return events

        class P:
            kineto_results = R()

        self.profiler = P()


def test_summary():
    ms = 1_000_000
    events = [
        Ev(trace.WINDOW, 0, 100 * ms, False),
        Ev(trace.WINDOW, 0, 100 * ms, True),          # mirrored span
        Ev("bench.call", 0, 60 * ms, False),
        Ev("aten::copy_", 10 * ms, 30 * ms, False),
        Ev("nccl:all_reduce", 70 * ms, 80 * ms, False),
        Ev("nccl:all_reduce", 70 * ms, 80 * ms, True),  # mirrored span
        Ev("Activity Buffer Request", 40 * ms, 50 * ms, False),
        Ev("void refine_head_kernel<64>(Args)", 0, 10 * ms, True),
        Ev("Memcpy HtoD (Pageable -> Device)", 5 * ms, 15 * ms, True),
        Ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 70 * ms, 80 * ms,
           True),
    ]
    s = trace.summarize(Prof(events))
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.025)        # 0-15 and 70-80
    assert set(s["kernels"]) == {"refine_head_kernel",
                                 "Memcpy HtoD (Pageable -> Device)",
                                 "ncclDevKernel_AllReduce_Sum_f32_RING_LL"}
    assert trace.kernel_time(s, "nccl") == (1, pytest.approx(0.01))
    gaps = dict((round(v, 3), n) for n, v in s["idle_gaps"])
    assert gaps[0.055] == "bench.call"                # 15-70: middle 42.5
    assert gaps[0.02] == "no host event"              # 80-100
    assert s["device_ops"][0][0] in ("refine_head_kernel",
                                     "Memcpy HtoD (Pageable -> Device)")
