"""The traced stretch: a profiler capture of whole calls, reduced to a
timeline the per-layer readers read.

The capture set-up is a copy of the port's (`saccot_tpu_torch/utils/
profiling.profiler`): on a card it opens with 128 launches of the spin
kernel of `torch.cuda._sleep`, which take the profiler's lost first device
records, and readers leave those records out by name. Each call of the
stretch runs in the range `regbench/call`. The stretch runs from the start
of its first call to the end of its last device operation; device
operations are the kernels, copies and fills the card ran (not the device
side of a range).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WARM_UP_LAUNCHES = 128
WARM_UP_KERNEL = "spin_kernel"
CALL_RANGE = "regbench/call"
_NOT_KERNELS = ("Memcpy", "Memset")


@contextlib.contextmanager
def capture():
    """`torch.profiler.profile` over the host and, on a card, its CUDA
    activity, opening with the warm-up launches; yields the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            with torch.profiler.record_function("profiler/warm_up"):
                for _ in range(WARM_UP_LAUNCHES):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def kernel_pattern(name: str) -> re.Pattern:
    """A kernel's function name as a whole word of a demangled signature."""
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")


@dataclasses.dataclass
class Timeline:
    """What the readers see of a stretch: `calls` whole calls over
    `window_s` seconds; `busy_s` the union of the device operations in it;
    `op_seconds` and `op_counts` by operation name; `gaps` the device's idle
    intervals, each named by what the host was doing when it began."""
    calls: int
    window_s: float
    busy_s: float
    op_seconds: Dict[str, float]
    op_counts: Dict[str, int]
    gaps: List[Tuple[str, float]]

    def kernel_names(self) -> List[str]:
        return [n for n in self.op_seconds if not n.startswith(_NOT_KERNELS)]

    def seconds_of(self, kernels: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose names hold
        one of `kernels` as a whole word."""
        pats = [kernel_pattern(k) for k in kernels]
        hit = [n for n in self.op_seconds if any(p.search(n) for p in pats)]
        return sum(self.op_seconds[n] for n in hit), sum(self.op_counts[n] for n in hit)

    def launches(self) -> int:
        return sum(self.op_counts[n] for n in self.kernel_names())

    def top_ops(self, k: int = 10) -> List[List]:
        ops = sorted(self.op_seconds.items(), key=lambda kv: kv[1], reverse=True)[:k]
        return [[name, sec] for name, sec in ops]

    def top_gaps(self, k: int = 10) -> List[List]:
        by_name: Dict[str, float] = {}
        for name, sec in self.gaps:
            by_name[name] = by_name.get(name, 0.0) + sec
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: kv[1],
                                          reverse=True)[:k]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(device_ops: List[Tuple[float, float, str]],
           host_ops: List[Tuple[float, float, str]],
           call_ranges: List[Tuple[float, float]]) -> Optional[Timeline]:
    """A timeline from raw intervals in seconds on one clock: device
    operations (start, end, name), the host thread's operations (start,
    end, name, innermost last where nested) and the calls' ranges (start,
    end). None when the stretch holds no call or no device operation."""
    if not call_ranges or not device_ops:
        return None
    t0 = min(s for s, _ in call_ranges)
    t1 = max(e for _, e, _ in device_ops)
    if t1 <= t0:
        return None
    seconds: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    spans = []
    for s, e, name in device_ops:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        seconds[name] = seconds.get(name, 0.0) + (e - s)
        counts[name] = counts.get(name, 0) + 1
        spans.append((s, e))
    busy = _union(spans)
    idle, prev = [], t0
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    host = sorted(host_ops)
    starts = [h[0] for h in host]
    gaps = [(_host_at(host, starts, s), e - s) for s, e in idle]
    return Timeline(calls=len(call_ranges), window_s=t1 - t0,
                    busy_s=sum(e - s for s, e in busy), op_seconds=seconds, op_counts=counts,
                    gaps=gaps)


def _host_at(host, starts, t: float, reach: int = 4096) -> str:
    """The innermost host operation running at t: the latest-starting one
    that contains it (ranges on one thread nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        s, e, name = host[j]
        if s <= t <= e:
            return name
    return "host_outside_ops"


def timeline(prof) -> Optional[Timeline]:
    """The Timeline of a `capture()` profile."""
    device, host, calls = [], [], []
    call_thread = None
    events = prof.events()
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.name == CALL_RANGE:
            call_thread = ev.thread
            calls.append((ev.time_range.start / 1e6, ev.time_range.end / 1e6))
    for ev in events:
        start, end = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or WARM_UP_KERNEL in ev.name:
                continue
            device.append((start, end, ev.name))
        elif ev.thread == call_thread and ev.name != CALL_RANGE:
            parent = ev.cpu_parent.name if ev.cpu_parent is not None else ""
            label = ev.name if parent in ("", CALL_RANGE) else f"{parent}/{ev.name}"
            host.append((start, end, label))
    return reduce(device, host, calls)
