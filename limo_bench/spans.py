"""Spans and the device trace of a `--trace 1` run.

Spans come from the benchmark's own wrappers around the port's
functions (`Tracer.patch`, `profile_step.py`'s way of labelling stages:
the function is replaced on its module, so the port's own calls go
through the wrapper).  In the window every span times its calls on the
host clock, summed per frame.  In the profiled frames after the window
each call is bracketed on the device by a marker kernel enqueued just
before and just after it, so the device time of a span is the time of
the activities that ran between its two markers: the ctypes launches of
the port's kernels, which the profiler ties to no host range, count too.

`DeviceTrace` reduces the profiler's events to what the per-layer
metrics read: busy time, activities, time between markers, the longest
operations and the longest idle gaps with what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

NO_HOST_CALL = "_no_host_call_"
GUARDS = 3  # markers launched ahead of the profiled frames


def marker() -> None:
    """A tiny kernel that marks a point of the device timeline."""
    torch.cuda._sleep(1)


class Tracer:
    """Host spans per frame, and markers and work records of the
    profiled frames."""

    def __init__(self):
        self.current = defaultdict(float)
        self.calls = defaultdict(int)
        self.host = defaultdict(list)  # label -> seconds per window frame
        self.labels = []
        self.profiling = False
        self.marks = []  # (label, 0 begin / 1 end), in launch order
        self.work = defaultdict(list)  # label -> work of each profiled call
        self._saved = []

    def patch(self, module, attr: str, label: str, work=None) -> None:
        """Wrap `module.attr` in the span `label`; `work(*args, **kw)`
        counts a profiled call's work."""
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            if self.profiling:
                marker()
                self.marks.append((label, 0))
                out = fn(*args, **kw)
                marker()
                self.marks.append((label, 1))
                if work is not None:
                    self.work[label].append(work(*args, **kw))
                return out
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.current[label] += time.perf_counter() - t0
            self.calls[label] += 1
            return out

        setattr(module, attr, wrapped)
        self._saved.append((module, attr, fn))
        if label not in self.labels:
            self.labels.append(label)

    def end_frame(self) -> None:
        if not self.profiling:
            for label in self.labels:
                self.host[label].append(self.current.pop(label, 0.0))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()

    def host_ms(self, label: str):
        """Mean host ms per window frame of a span, or None if the span
        was never entered."""
        if not self.calls.get(label):
            return None
        v = self.host[label]
        return 1e3 * sum(v) / len(v)


def marker_name(tries: int = 3) -> str:
    """The device name of the marker kernel, read from a trace of it (a
    trace now and then comes back without device records: taken again)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if len(names) == 1:
            return names.pop()
        time.sleep(1.0)
    raise RuntimeError(f"the marker traced as {sorted(names)}")


class DeviceTrace:
    """The device activities of a profiled stretch, in time order."""

    def __init__(self, prof, marker: str, window_s: float, frames: int,
                 launched: int):
        dev, host = [], []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.time_range.start, e.time_range.end, e.name))
            else:
                host.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        marks = [d for d in dev if d[2] == marker]
        # the last `launched` markers are the spans'; the guards before
        # them may have lost one
        self.aligned = len(marks) >= launched
        self.marks = marks[len(marks) - launched:] if self.aligned else []
        self.ops = [d for d in dev if d[2] != marker]
        self.host = host
        self.window_s = window_s
        self.frames = frames

    def busy_s(self) -> float:
        """Seconds in which an activity ran (overlaps counted once)."""
        total, end = 0.0, float("-inf")
        for s, e, _ in self.ops:
            if e > end:
                total += e - max(s, end)
                end = e
        return total * 1e-6

    def activities_per_frame(self) -> float:
        return len(self.ops) / self.frames

    def span_s(self, marks: list, label: str) -> list:
        """Device seconds of every call of span `label`: the activities
        that started between its begin marker's end and its end
        marker's start.  `marks` is the launch order of the markers."""
        opened, out = [], []
        starts = [s for s, _, _ in self.ops]
        for (lab, kind), (s, e, _) in zip(marks, self.marks):
            if lab != label:
                continue
            if kind == 0:
                opened.append(e)
                continue
            begin = opened.pop()
            lo = bisect.bisect_left(starts, begin)
            hi = bisect.bisect_left(starts, s)
            out.append(sum(oe - os for os, oe, _ in self.ops[lo:hi]) * 1e-6)
        return out

    def top_ops(self, n: int = 10) -> list:
        """The n device operations that took most time, in seconds."""
        by = defaultdict(float)
        for s, e, name in self.ops:
            by[name[:64]] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between device activities, each named by
        the innermost host operation running at its middle."""
        gaps = []
        for (_, e0, _), (s1, _, _) in zip(self.ops, self.ops[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, e0, s1))
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [(he - hs, name) for hs, he, name in self.host
                     if hs <= mid <= he]
            out.append([min(inner)[1][:64] if inner else NO_HOST_CALL,
                        length * 1e-6])
        return out
