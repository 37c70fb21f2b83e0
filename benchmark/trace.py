"""Reading a ``torch.profiler`` trace of the measured window.

The window is traced with the device's activity alone (kernels, copies,
fills and the CUDA runtime calls that launch them): no host operator is
recorded, so the trace costs the host little and the idle share and the
rates read from it stay close to an untraced run's. The benchmark's own
spans (``span``) are kept by the host's clock.

The device's busy time is the union of its activity intervals inside the
window, so overlapping events count once. The window is the host's: from
just before a marker kernel, launched on an idle device, to the
synchronize after the last step; the marker's start puts the host's clock
onto the trace's. Idle gaps are labelled by what the host was doing at
their middle: the CUDA runtime call that covered it, else the innermost
benchmark span, else "host (no span)": the program's own host work
between launches.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[str, int, int]        # (name, start ns, end ns)

# the benchmark's spans of the window being traced, by the host's clock
# (time.time_ns), or None when no window is traced
_SPANS: Optional[List[Interval]] = None


class Trace:
    """The window's device intervals and the main thread's host spans."""

    def __init__(self, device: List[Interval], host: List[Interval],
                 t0: int, t1: int, kernels: int = 0):
        self.device = device
        self.kernels = kernels
        self.host = host
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.device]) / 1e9

    def kernel_seconds(self, match) -> float:
        """Summed device seconds of the intervals whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9


def clip(intervals, t0: int, t1: int):
    for n, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            yield n, s, e


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(device: Sequence[Interval], t0: int, t1: int
         ) -> List[Tuple[int, int]]:
    """The idle intervals of [t0, t1): the complement of the union."""
    out, at = [], t0
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def _kind(e, cuda) -> str:
    """"kernel", "copy" (a device copy or fill), "device" (another device
    event) or "host" (a runtime call)."""
    act = e.activity_type() if hasattr(e, "activity_type") else None
    if act is not None:
        if act == "kernel":
            return "kernel"
        if act in DEVICE_ACTIVITIES:
            return "copy"
        return "host" if act in ("cpu_op", "user_annotation",
                                 "cuda_runtime", "cuda_driver") else "device"
    if e.device_type() != cuda:
        return "host"
    if e.is_user_annotation():
        return "device"
    name = e.name()
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


class Window:
    """The host's marks of a traced window: ``start`` synchronizes the
    device, reads the clock and launches the marker kernel; ``stop``
    synchronizes and reads the clock again."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.thread = threading.get_native_id()
        self.t0 = self.t1 = 0

    def start(self) -> None:
        global _SPANS
        self.torch.cuda.synchronize(self.device)
        _SPANS = []
        self.t0 = time.time_ns()
        self.torch.zeros(1, device=self.device).add_(1.0)

    def stop(self) -> List[Interval]:
        global _SPANS
        self.torch.cuda.synchronize(self.device)
        self.t1 = time.time_ns()
        spans, _SPANS = _SPANS, None
        return spans


def from_profiler(prof, window: Window, spans: List[Interval]) -> Trace:
    """The trace of a finished profiler around ``window``: device
    intervals and the host's runtime calls on the trace's clock, the
    window and the benchmark's ``spans`` moved onto it by the marker (the
    first device event: the device was idle when it was launched)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, runtime, kernel_at = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, cuda)
        if kind in ("kernel", "copy"):
            device.append((e.name(), e.start_ns(), e.end_ns()))
            if kind == "kernel":
                kernel_at.append(e.start_ns())
        elif kind == "host":
            runtime.append((e.name(), e.start_ns(), e.end_ns(),
                            e.start_thread_id()))
    if not device:
        raise RuntimeError("the traced window has no device event")
    shift = min(s for _, s, _ in device) - window.t0
    t0, t1 = window.t0 + shift, window.t1 + shift
    main = [r for r in runtime if r[3] == window.thread]
    host = [(n, s, e) for n, s, e, _ in (main or runtime)]
    host += [(n, s + shift, e + shift) for n, s, e in spans]
    return Trace(list(clip(device, t0, t1)), list(clip(host, t0, t1)), t0,
                 t1, sum(1 for t in kernel_at if t0 <= t < t1))


def label_at(host: List[Interval], starts: List[int],
             bench: List[Interval], t: int) -> str:
    """The innermost host span covering time ``t``: the latest-starting
    runtime call among the last 512 started before ``t`` that has not
    ended, else the innermost benchmark span (``bench.*``), else "host (no
    span)"."""
    i = bisect.bisect_right(starts, t)
    for n, s, e in reversed(host[max(0, i - 512):i]):
        if e > t:
            return n
    best = None
    for n, s, e in bench:
        if s <= t < e and (best is None or s >= best[1]):
            best = (n, s)
    return best[0] if best else "host (no span)"


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time, and the idle time by
    what the host was doing, ``top`` of each, in seconds."""
    by_op: Dict[str, int] = collections.Counter()
    for n, s, e in trace.device:
        by_op[n] += e - s
    bench = [h for h in trace.host if h[0].startswith("bench.")]
    host = sorted((h for h in trace.host if not h[0].startswith("bench.")),
                  key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    by_gap: Dict[str, int] = collections.Counter()
    for s, e in gaps(trace.device, trace.t0, trace.t1):
        by_gap[label_at(host, starts, bench, (s + e) // 2)] += e - s
    return {"device_ops": [[n, v / 1e9] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v / 1e9] for n, v in by_gap.most_common(top)]}


@contextlib.contextmanager
def span(name: str):
    """A benchmark span of the traced window, by the host's clock (nothing
    when no window is traced)."""
    spans = _SPANS
    if spans is None:
        yield
        return
    t = time.time_ns()
    try:
        yield
    finally:
        spans.append((name, t, time.time_ns()))


@contextlib.contextmanager
def maybe_profile(enabled: bool):
    """A profiler of the device's activity around the window, or nothing;
    yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
