"""The reduction of a profiler trace: the union of device intervals, the
idle gaps and what the host was doing in them."""

from benchmark import trace


def test_union_counts_overlaps_once():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert trace.union_ns([(0, 10), (10, 20)]) == 20
    assert trace.union_ns([]) == 0


def test_busy_idle_and_breakdown():
    dev = [("gemm", 0, 40), ("copy", 30, 50), ("gemm", 70, 90),
           ("pool", 90, 95)]
    host = [("bench.loader_next", 50, 70), ("aten::item", 55, 65),
            ("aten::mm", 0, 5)]
    tr = trace.Trace(dev, host, 0, 100, kernels=3)
    assert abs(tr.busy_s() - 75e-9) < 1e-15
    assert trace.gaps(dev, 0, 100) == [(50, 70), (95, 100)]
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["gemm", 60e-9]
    # the gap 50-70 has aten::item at its middle; 95-100 no span
    assert dict((n, v) for n, v in bd["idle_gaps"]) == {
        "aten::item": 20e-9, "host (no span)": 5e-9}
    assert abs(tr.kernel_seconds(lambda n: n == "gemm") - 60e-9) < 1e-15


def test_gap_falls_back_to_the_benchmark_span():
    host = [("bench.loader_next", 0, 100)] + [
        (f"aten::op{i}", i * 0.01, i * 0.01 + 0.005) for i in range(600)]
    starts = sorted(s for _, s, _ in host)
    host = sorted(host, key=lambda x: x[1])
    bench = [h for h in host if h[0].startswith("bench.")]
    assert trace.label_at(host, starts, bench, 50) == "bench.loader_next"


class _Event:
    def __init__(self, name, kind, start, end, thread=7):
        self._name, self._kind = name, kind
        self._start, self._end, self._thread = start, end, thread

    def name(self):
        return self._name

    def activity_type(self):
        return self._kind

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def start_thread_id(self):
        return self._thread


class _Profiler:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def test_the_marker_puts_the_host_window_on_the_trace_clock():
    # the trace's clock runs 1000 ns ahead of the host's; the marker (the
    # first device event) starts at the host's t0
    events = [_Event("fill", "gpu_memset", 1100, 1105),
              _Event("gemm", "kernel", 1120, 1160),
              _Event("cudaStreamSynchronize", "cuda_runtime", 1165, 1190),
              _Event("cudaLaunchKernel", "cuda_runtime", 1110, 1112, 9),
              _Event("late", "kernel", 1195, 1300)]
    window = trace.Window.__new__(trace.Window)
    window.thread, window.t0, window.t1 = 7, 100, 200
    tr = trace.from_profiler(_Profiler(events), window,
                             [("bench.loader_next", 170, 190)])
    assert (tr.t0, tr.t1) == (1100, 1200) and tr.window_s == 100e-9
    assert tr.kernels == 2                   # gemm, and late (clipped)
    assert abs(tr.busy_s() - 50e-9) < 1e-15  # 5 + 40 + 5
    # the runtime calls of the window's thread, and the span moved on
    assert sorted(tr.host) == [("bench.loader_next", 1170, 1190),
                               ("cudaStreamSynchronize", 1165, 1190)]
    gaps = dict(trace.breakdown(tr)["idle_gaps"])
    assert gaps == {"cudaStreamSynchronize": 35e-9,
                    "host (no span)": 15e-9}


def test_a_span_is_kept_only_while_a_window_is_traced():
    with trace.span("bench.x"):
        pass
    assert trace._SPANS is None
    trace._SPANS = []
    try:
        with trace.span("bench.x"):
            pass
        assert [n for n, _, _ in trace._SPANS] == ["bench.x"]
    finally:
        trace._SPANS = None
