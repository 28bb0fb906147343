"""The port's own spans (`obs/timing.span` in `mono_lidar_depth_tpu_torch`),
read for the per-layer metrics that name them.

Host clock: the port keeps each span's host time per frame in a ring of
the last 1,024 frames it ran with no profiler, and `frame_spans()` reads
it; a metric takes the median ms per frame.  In a `--trace 1` run those
are the window's frames (the profiled frames are not recorded).

Device clock: while the profiler records, each span is a host range of
the trace named after it, with no device-side event.  Every activity of
the cell runs on one stream, so the launch calls (`cudaLaunchKernel*`,
`cuLaunchKernel*`, `cudaMemcpy*`, `cudaMemset*`) and the device's
activities (the trace's operations and the harness's span markers) pair
one to one in order; the launch calls made before the profiled frames
(before the first device synchronize, the harness's guard markers, whose
activities the trace drops) are left out.  A span's device time is that
of the activities which the launch calls inside its ranges enqueued,
the harness's markers left out.  Where the counts differ, or a copy or a
fill is paired with an activity of another kind, the pairing does not
hold: the device metrics read nothing and say why on standard error.
Start times are not compared: the profiler's device clock may read a few
microseconds behind the host's (an activity seen up to 2.8 us before its
launch call on the H100), while copies and fills come every ~16 launch
calls and so find a shift by one within a frame.

Against a port without spans every reader returns None.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import sys

PORT_TIMING = "mono_lidar_depth_tpu_torch.obs.timing"
FRAME = "assoc.frame"
SPANS = (FRAME, "assoc.ground_plane", "assoc.match_tracks",
         "assoc.rasterize", "assoc.depth_pair", "depth.segment",
         "depth.road", "assoc.update_tracks")
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize")
DEVICE_SYNC = "cudaDeviceSynchronize"
# (launch call's prefix, its activity's prefix): a copy and a fill; any
# other launch call enqueues a kernel
KINDS = (("cudaMemcpy", "Memcpy"), ("cudaMemset", "Memset"))


def host_ms(name: str):
    """Median host ms per frame of the port's span `name`, or None."""
    timing = importlib.import_module(PORT_TIMING)
    read = getattr(timing, "frame_spans", None)
    got = read().get(name) if read is not None else None
    return None if got is None else got["median_ms"]


def launch_kind(name: str) -> int:
    """0 a copy, 1 a fill, 2 a kernel launch call."""
    return next((k for k, (call, _) in enumerate(KINDS)
                 if name.startswith(call)), len(KINDS))


def activity_kind(name: str) -> int:
    """0 a copy, 1 a fill, 2 a kernel."""
    return next((k for k, (_, act) in enumerate(KINDS)
                 if name.startswith(act)), len(KINDS))


def is_sync(name: str) -> bool:
    """A host call that waits for the card: a synchronize, or a copy that
    is not asynchronous."""
    return name in SYNC or (name.startswith("cudaMemcpy")
                            and "Async" not in name)


class Program:
    """The spans' ranges, launch calls and idle time of one profiled
    stretch (`spans.DeviceTrace`)."""

    def __init__(self, trace):
        self.frames = trace.frames
        self.ranges = {n: [] for n in SPANS}
        launches, syncs, device_syncs = [], [], []
        for s, e, name in trace.host:
            if name in self.ranges:
                self.ranges[name].append((s, e))
            elif name.startswith(LAUNCH):
                launches.append((s, launch_kind(name)))
            if is_sync(name):
                syncs.append(s)
            if name == DEVICE_SYNC:
                device_syncs.append(e)
        for r in self.ranges.values():
            r.sort()
        self.syncs = sorted(syncs)
        self.why = None
        if not any(self.ranges.values()):
            self.why = "no span of the program in the trace"
            return
        if not device_syncs:
            self.why = "no device synchronize in the trace"
            return
        # the profiled frames: from the synchronize after the guard
        # markers to the last synchronize
        self.begin, self.end = min(device_syncs), max(device_syncs)
        launches = sorted(x for x in launches if x[0] >= self.begin)
        acts = sorted([(s, e, False, activity_kind(n))
                       for s, e, n in trace.ops]
                      + [(s, e, True, activity_kind(n))
                         for s, e, n in trace.marks])
        if len(launches) != len(acts):
            self.why = (f"{len(launches)} launch calls and {len(acts)} "
                        f"device activities in the profiled frames")
            return
        apart = sum(k != a[3] for (_, k), a in zip(launches, acts))
        if apart:
            self.why = (f"{apart} of {len(acts)} launch calls paired with "
                        f"an activity of another kind")
            return
        self.launches = [s for s, _ in launches]
        self.acts = acts
        self.ops = sorted((s, e) for s, e, _ in trace.ops)

    def inside(self, name: str, starts: list) -> list:
        """Indices of `starts` (sorted) that lie inside a range of
        `name`."""
        out = []
        for s, e in self.ranges[name]:
            lo = bisect.bisect_left(starts, s)
            hi = bisect.bisect_right(starts, e)
            out.extend(range(lo, hi))
        return out

    def device_ms(self, name: str):
        """Device ms per profiled frame that span `name` enqueued."""
        if self.why is not None or not self.ranges[name]:
            return None
        total = sum(self.acts[i][1] - self.acts[i][0]
                    for i in self.inside(name, self.launches)
                    if not self.acts[i][2])
        return 1e-3 * total / self.frames

    def host_syncs(self):
        """Host calls that wait for the card inside `assoc.frame`, per
        profiled frame."""
        if not self.ranges[FRAME]:
            return None
        return len(self.inside(FRAME, self.syncs)) / self.frames

    def idle_ms(self):
        """(inside `assoc.frame`, outside it): device-idle ms per profiled
        frame over the profiled frames."""
        if self.why is not None or not self.ranges[FRAME]:
            return None
        idle, t = [], self.begin
        for s, e in self.ops:
            if s > t:
                idle.append((t, min(s, self.end)))
            t = max(t, e)
            if t >= self.end:
                break
        if t < self.end:
            idle.append((t, self.end))
        frames = self.ranges[FRAME]
        total = sum(b - a for a, b in idle if b > a)
        within = 0.0
        for a, b in idle:
            for s, e in frames[max(bisect.bisect_left(frames, (a,)) - 1, 0):]:
                if s >= b:
                    break
                within += max(0.0, min(b, e) - max(a, s))
        return (1e-3 * within / self.frames,
                1e-3 * (total - within) / self.frames)


@functools.lru_cache(maxsize=1)
def program(trace) -> Program:
    p = Program(trace)
    if p.why is not None:
        print(f"limo_bench: the program's spans give no device time: "
              f"{p.why}", file=sys.stderr)
    return p


def device_ms(r, name: str):
    return program(r.trace).device_ms(name)


def host_syncs(r):
    return program(r.trace).host_syncs()


def idle_ms(r, inside: bool):
    got = program(r.trace).idle_ms()
    return None if got is None else got[0 if inside else 1]
