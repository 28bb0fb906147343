"""Per-stage wall-clock timing, the program's own spans, and the profiler
hook (counterpart of obs/timing.py, which has the first and the last).

`StageTimer`: the caller wraps a stage; CUDA work is launched
asynchronously, so a span that observed a result on a card ends with
`torch.cuda.synchronize` of that card; on the CPU there is nothing to
wait for.

`span(name)`: the program's own stage spans, placed at its call sites
(`tracks/pipeline.process_frame` and its stages, the depth cascade's
parts).  A span never synchronizes the card.

* Host clock: with no profiler running, each span adds its
  `time.perf_counter` duration (its children included) to the frame
  record that is open.  A span entered with `frame=True` opens the record
  when none is open and closes the one it opened; a span entered with no
  record open is not recorded.  Closed records go into a ring of the last
  `RING_FRAMES` frames.  With no profiler running a span costs one flag
  read, two clock reads and one addition.
* Profiler clock: while a torch profiler records, a span keeps no record
  (a profiled frame's host time is the profiler's) and opens a profiler
  range named after it instead, of a kind that makes no device-side
  event (a `gpu_user_annotation` would land among the device's
  activities), so each launch call, and each idle gap of the card, can be
  placed in the stage the host was in.

`frame_spans()` reads the ring: per span name, the median, mean and 95th
percentile of its host ms per frame over the frames of the ring that
entered it, and their number.  The spans are single-threaded: one stream
of frames per process.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict, deque
from typing import Any

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists and
    dicts."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in tree)) if tree else set()
    return set()


class StageTimer:
    """Accumulating named-span timer.

    Usage:
        timer = StageTimer()
        with timer.span("depth"):
            out = timer.observe(estimate_depths(...))   # waited for on exit
        print(timer.report())
    """

    def __init__(self, sync: bool = True):
        self._sync = sync
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._last_result: Any = None

    @contextlib.contextmanager
    def span(self, name: str, result: Any = None):
        start = time.perf_counter()
        try:
            yield self
        finally:
            if self._sync and self._last_result is not None:
                for dev in _cuda_devices(self._last_result):
                    torch.cuda.synchronize(dev)
                self._last_result = None
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    def observe(self, result: Any) -> Any:
        """Register device values to wait for when the span exits."""
        self._last_result = result
        return result

    def totals(self) -> dict[str, float]:
        return dict(self._totals)

    def report(self) -> str:
        lines = [f"{'stage':32s} {'total s':>10s} {'calls':>7s} {'ms/call':>10s}"]
        for name, total in sorted(self._totals.items(), key=lambda kv: -kv[1]):
            n = self._counts[name]
            lines.append(f"{name:32s} {total:10.3f} {n:7d} {1e3 * total / n:10.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler trace of the region (CPU and, where there is a card,
    CUDA activities), written to `logdir` as a Chrome trace."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


RING_FRAMES = 1024
_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter


class _Frames:
    """The open frame record (span name -> host seconds) and the ring of
    the closed ones."""

    def __init__(self):
        self.open: dict | None = None
        self.ring: deque = deque(maxlen=RING_FRAMES)

    def clear(self) -> None:
        self.open = None
        self.ring.clear()


_frames = _Frames()


class span:
    """The program's span `name` (module docstring); `frame=True` on the
    root span of a frame."""

    __slots__ = ("name", "frame", "opened", "t0", "range")

    def __init__(self, name: str, frame: bool = False):
        self.name = name
        self.frame = frame
        self.opened = False
        self.t0 = None
        self.range = None

    def __enter__(self) -> "span":
        if _profiling():
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
            return self
        if _frames.open is None:
            if not self.frame:
                return self
            _frames.open = {}
            self.opened = True
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
            return
        if self.t0 is None:
            return
        record = _frames.open
        record[self.name] = record.get(self.name, 0.0) + (_clock() - self.t0)
        if self.opened:
            _frames.open = None
            if exc_type is None:
                _frames.ring.append(record)


def frame_spans() -> dict:
    """Per span name over the ring: `median_ms`, `mean_ms` and `p95_ms` of
    its host ms per frame, over the `frames` of the ring that entered
    it."""
    per: dict = defaultdict(list)
    for record in _frames.ring:
        for name, seconds in record.items():
            per[name].append(1e3 * seconds)
    out = {}
    for name, ms in per.items():
        p95 = (statistics.quantiles(ms, n=20, method="inclusive")[18]
               if len(ms) > 1 else ms[0])
        out[name] = {"median_ms": statistics.median(ms),
                     "mean_ms": statistics.fmean(ms), "p95_ms": p95,
                     "frames": len(ms)}
    return out
